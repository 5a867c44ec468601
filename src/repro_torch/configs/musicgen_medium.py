"""musicgen-medium [audio] — decoder-only over EnCodec tokens.
[arXiv:2306.05284; hf]  48L d_model=1536 24H kv=24(MHA) d_ff=6144 vocab=2048.
The EnCodec frontend is a stub: the batch's tokens may be precomputed frame
embeddings (B,S,d_model); the LM head predicts the 2048-way codebook.
"""
from repro_torch.common.config import ModelConfig, ATTN

FULL = ModelConfig(
    name="musicgen-medium", family="audio",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24,
    d_ff=6144, vocab_size=2048,
    pattern=(ATTN,), mlp_kind="gelu",
)

SMOKE = ModelConfig(
    name="musicgen-smoke", family="audio",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=4,
    d_ff=128, vocab_size=64,
    pattern=(ATTN,), mlp_kind="gelu",
    dtype="float32", param_dtype="float32", remat=False,
)
