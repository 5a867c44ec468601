"""granite-4.0-h-micro [hybrid] — Mamba2 and NoPE GQA attention, a SwiGLU
MLP after every mixer, Granite's multipliers (`granitemoehybrid`).
[hf:ibm-granite/granite-4.0-h-micro config.json]  40L d_model=2048
layer_types a period of 10 (attention at 5); Mamba2 64 heads x 64, state
128, 1 group, chunk 256; attention 32 x 64 over 8 kv heads, no RoPE,
scale 1/64; MLP 8192; vocab 100352 tied; multipliers embedding 12,
residual 0.22, logits 1/8.

The port's own: the JAX package has no such model, so it is reached
through `configs.get_config` but is not one of `ARCH_IDS`.
"""
from repro_torch.common.config import (ATTN, MAMBA2, GraniteHybridConfig,
                                       SSMConfig)

PATTERN = (MAMBA2,) * 5 + (ATTN,) + (MAMBA2,) * 4

FULL = GraniteHybridConfig(
    name="granite-4.0-h-micro", family="hybrid",
    num_layers=40, d_model=2048, num_heads=32, num_kv_heads=8, head_dim=64,
    d_ff=8192, vocab_size=100352,
    pattern=PATTERN, mlp_kind="swiglu",
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
    position_embedding="none", attention_scale=0.015625,
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=8.0,
)

# two periods; every multiplier and the scale (1/h, not 1/sqrt(h)) unlike
# 1, so the CPU tests hold each
SMOKE = GraniteHybridConfig(
    name="granite-h-smoke", family="hybrid",
    num_layers=20, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
    d_ff=96, vocab_size=128,
    pattern=PATTERN, mlp_kind="swiglu",
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  n_groups=1, chunk_size=8),
    tie_embeddings=True, dtype="float32", param_dtype="float32", remat=False,
    position_embedding="none", attention_scale=1.0 / 16,
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=8.0,
)
