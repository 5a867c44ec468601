"""qwen1.5-110b [dense] — GQA kv=8 with QKV bias.
[hf:Qwen/Qwen1.5-0.5B; hf]  80L d_model=8192 64H kv=8 d_ff=49152 vocab=152064.
"""
from repro_torch.common.config import ModelConfig, ATTN

FULL = ModelConfig(
    name="qwen1.5-110b", family="dense",
    num_layers=80, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=49152, vocab_size=152064,
    pattern=(ATTN,), mlp_kind="swiglu", qkv_bias=True,
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="qwen-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    pattern=(ATTN,), mlp_kind="swiglu", qkv_bias=True,
    dtype="float32", param_dtype="float32", remat=False,
)
