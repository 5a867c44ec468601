"""llama-3.2-vision-90b [vlm] — cross-attention image layers every 5th.
[hf:meta-llama/Llama-3.2-11B-Vision; unverified]
100L d_model=8192 64H kv=8 d_ff=28672 vocab=128256.
Vision frontend is a stub: the batch's `cond` holds precomputed patch
embeddings (n_cond_tokens x d_model) consumed by the cross-attn layers.
"""
from repro_torch.common.config import ModelConfig, ATTN, CROSS_ATTN

FULL = ModelConfig(
    name="llama-3.2-vision-90b", family="vlm",
    num_layers=100, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    pattern=(ATTN, ATTN, ATTN, ATTN, CROSS_ATTN),
    n_cond_tokens=6400,   # 4 tiles x 1600 patches
    mlp_kind="swiglu",
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="llama-vision-smoke", family="vlm",
    num_layers=5, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    pattern=(ATTN, ATTN, ATTN, ATTN, CROSS_ATTN), n_cond_tokens=8,
    mlp_kind="swiglu",
    dtype="float32", param_dtype="float32", remat=False,
)
