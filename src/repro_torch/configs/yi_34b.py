"""Yi-34B. [arXiv:2403.04652; hf] llama-arch GQA.
60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000."""
from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="yi-34b",
    family="dense",
    n_layers=60,
    d_model=7168,
    n_heads=56,             # 56*128=7168 divides the 16-way model axis
    n_kv=8,
    d_head=128,
    d_ff=20480,
    vocab=64000,
    rope_theta=5e6,
)
