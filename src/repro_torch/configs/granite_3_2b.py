"""Granite-3.0-2B. [hf:ibm-granite/granite-3.0-2b-base; hf]
40L d_model=2048 32H (GQA kv=8) d_ff=8192 vocab=49155.
(Granite's mup-style scaling multipliers omitted — structural config.)"""
from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="granite-3-2b",
    family="dense",
    n_layers=40,
    d_model=2048,
    n_heads=32,
    n_kv=8,
    d_head=64,
    d_ff=8192,
    vocab=49155,
    rope_theta=1e4,
)
