"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.
[arXiv:2405.21060; unverified]  48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128.
"""
from repro_torch.common.config import ModelConfig, SSMConfig, MAMBA2

FULL = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=50280,
    pattern=(MAMBA2,),
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, conv_width=4,
                  n_groups=1, chunk_size=256),
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-smoke", family="ssm",
    num_layers=2, d_model=64, num_heads=1, num_kv_heads=1,
    d_ff=0, vocab_size=128,
    pattern=(MAMBA2,),
    ssm=SSMConfig(d_state=16, head_dim=16, expand=2, conv_width=4,
                  n_groups=1, chunk_size=8),
    tie_embeddings=True, dtype="float32", param_dtype="float32", remat=False,
)
