"""dbrx-132b [moe] — 16 experts top-4, fine-grained.
[hf:databricks/dbrx-base; unverified]
40L d_model=6144 48H kv=8 d_ff=10752(per-expert) vocab=100352.
"""
from repro_torch.common.config import ModelConfig, MoEConfig, ATTN

FULL = ModelConfig(
    name="dbrx-132b", family="moe",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=8,
    d_ff=0, vocab_size=100352,
    pattern=(ATTN,), mlp_kind="swiglu",
    moe=MoEConfig(num_experts=16, top_k=4, d_ff=10752,
                  capacity_factor=1.25, group_size=512),
    grad_accum=4,
)

SMOKE = ModelConfig(
    name="dbrx-smoke", family="moe",
    num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
    d_ff=0, vocab_size=128,
    pattern=(ATTN,), mlp_kind="swiglu",
    # capacity_factor = E/top_k -> capacity == group tokens: no drops
    moe=MoEConfig(num_experts=4, top_k=2, d_ff=32, group_size=32,
                  capacity_factor=2.0),
    dtype="float32", param_dtype="float32", remat=False,
)
