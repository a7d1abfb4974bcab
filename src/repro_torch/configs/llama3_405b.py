"""Llama-3.1 405B. [arXiv:2407.21783; unverified]
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256."""
import torch

from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv=8,
    d_head=128,
    d_ff=53248,
    vocab=128256,
    rope_theta=5e5,
    param_dtype=torch.bfloat16,   # 405B: see DESIGN.md memory budget
    compute_dtype=torch.bfloat16,
)
