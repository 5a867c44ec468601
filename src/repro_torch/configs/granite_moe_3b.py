"""granite-moe-3b-a800m [moe] — fine-grained MoE, 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]
32L d_model=1536 24H kv=8 d_ff=512(per-expert) vocab=49155.
Small experts => GShard dispatch overhead matters; group_size=128 keeps
the dispatch einsum <10% of expert FLOPs.
"""
from repro_torch.common.config import ModelConfig, MoEConfig, ATTN

FULL = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    num_layers=32, d_model=1536, num_heads=24, num_kv_heads=8,
    d_ff=0, vocab_size=49155,
    pattern=(ATTN,), mlp_kind="swiglu",
    moe=MoEConfig(num_experts=40, top_k=8, d_ff=512, capacity_factor=1.25,
                  group_size=128),
)

SMOKE = ModelConfig(
    name="granite-moe-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=0, vocab_size=128,
    pattern=(ATTN,), mlp_kind="swiglu",
    # capacity_factor = E/top_k -> capacity == group tokens: no drops
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=32, group_size=32,
                  capacity_factor=2.0),
    dtype="float32", param_dtype="float32", remat=False,
)
