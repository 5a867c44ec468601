"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1:2 ratio.
[arXiv:2402.19427; hf]  26L d_model=2560 10H kv=1(MQA) d_ff=7680 vocab=256000.
Pattern (R,R,A)x8 + (R,R) tail = 26 layers; sliding window 2048.
"""
from repro_torch.common.config import (ModelConfig, RGLRUConfig, RGLRU,
                                       LOCAL_ATTN)

FULL = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    num_layers=26, d_model=2560, num_heads=10, num_kv_heads=1,
    d_ff=7680, vocab_size=256000, head_dim=256,
    pattern=(RGLRU, RGLRU, LOCAL_ATTN), window_size=2048,
    rglru=RGLRUConfig(lru_width=2560, conv_width=4),
    mlp_kind="gelu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-smoke", family="hybrid",
    num_layers=5, d_model=64, num_heads=4, num_kv_heads=1,
    d_ff=128, vocab_size=128, head_dim=16,
    pattern=(RGLRU, RGLRU, LOCAL_ATTN), window_size=8,
    rglru=RGLRUConfig(lru_width=64, conv_width=4),
    mlp_kind="gelu", tie_embeddings=True,
    dtype="float32", param_dtype="float32", remat=False,
)
