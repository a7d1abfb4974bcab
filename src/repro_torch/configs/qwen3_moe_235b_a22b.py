"""Qwen3-235B-A22B MoE. [hf:Qwen/Qwen3-30B-A3B family; hf]
94L d_model=4096 64H (GQA kv=4) expert d_ff=1536 vocab=151936,
128 experts top-8, head_dim 128."""
import torch

from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv=4,
    d_head=128,
    d_ff=1536,              # per-expert intermediate
    d_ff_expert=1536,
    vocab=151936,
    n_experts=128,
    top_k=8,
    rope_theta=1e6,
    param_dtype=torch.bfloat16,   # 235B: bf16 resident + f32 master offchip
    compute_dtype=torch.bfloat16,
)
