"""command-r-35b [dense] — GQA kv=8, no biases.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H kv=8 d_ff=22528 vocab=256000.
"""
from repro_torch.common.config import ModelConfig, ATTN

FULL = ModelConfig(
    name="command-r-35b", family="dense",
    num_layers=40, d_model=8192, num_heads=64, num_kv_heads=8,
    d_ff=22528, vocab_size=256000,
    pattern=(ATTN,), mlp_kind="swiglu", qkv_bias=False,
    grad_accum=2,
)

SMOKE = ModelConfig(
    name="command-r-smoke", family="dense",
    num_layers=2, d_model=64, num_heads=8, num_kv_heads=2,
    d_ff=128, vocab_size=128,
    pattern=(ATTN,), mlp_kind="swiglu",
    dtype="float32", param_dtype="float32", remat=False,
)
