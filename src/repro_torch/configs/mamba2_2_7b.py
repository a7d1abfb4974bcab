"""Mamba2-2.7B (SSD). [arXiv:2405.21060; unverified]
64L d_model=2560 attn-free, ssm_state=128, headdim 64, expand 2.
Sub-quadratic: runs the long_500k cell."""
from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    subquadratic=True,
)
