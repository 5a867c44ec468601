"""glm4-9b [dense] — RoPE, aggressive GQA (kv=2).
[hf:THUDM/glm-4-9b; hf]  40L d_model=4096 32H kv=2 d_ff=13696 vocab=151552.
"""
from repro_torch.common.config import ModelConfig, ATTN

FULL = ModelConfig(
    name="glm4-9b", family="dense",
    num_layers=40, d_model=4096, num_heads=32, num_kv_heads=2,
    d_ff=13696, vocab_size=151552,
    pattern=(ATTN,), mlp_kind="swiglu", rope_theta=10_000.0,
)

SMOKE = ModelConfig(
    name="glm4-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    pattern=(ATTN,), mlp_kind="swiglu",
    dtype="float32", param_dtype="float32", remat=False,
)
