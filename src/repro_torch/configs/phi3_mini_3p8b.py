"""phi3-mini-3.8b [dense] — RoPE SwiGLU GQA(kv=32 -> MHA).
[arXiv:2404.14219; unverified]  32L d_model=3072 32H d_ff=8192 vocab=32064.
"""
from repro_torch.common.config import ModelConfig, ATTN

FULL = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=32064,
    pattern=(ATTN,), mlp_kind="swiglu", rope_theta=10_000.0,
    # the JAX package's training layout: pure ZeRO-3/FSDP (batch over all
    # devices, weights gathered per layer), remat on
    sharding_overrides=(
        ("batch", ("pod", "data", "model")),
        ("embed", ("data", "model")),
        ("heads", None), ("kv_heads", None), ("mlp", None),
        ("vocab", None), ("seq", None),
    ),
)

SMOKE = ModelConfig(
    name="phi3-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=128,
    pattern=(ATTN,), mlp_kind="swiglu",
    dtype="float32", param_dtype="float32", remat=False,
)
