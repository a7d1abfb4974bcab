"""Zamba2-2.7B hybrid. [arXiv:2411.15242; hf]
54 mamba2 layers + ONE shared attention block applied every 6 layers;
32H MHA d_head=80, d_ff=10240, ssm_state=64, vocab=32000.
Sub-quadratic backbone: runs the long_500k cell."""
from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv=32,
    d_head=80,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    hybrid_attn_every=6,
    subquadratic=True,
)
