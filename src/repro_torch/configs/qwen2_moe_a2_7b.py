"""Qwen1.5-MoE-A2.7B. [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]
24L d_model=2048 16H (MHA kv=16) expert d_ff=1408 vocab=151936,
60 routed top-4 + 4 shared experts, qkv bias."""
from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv=16,
    d_head=128,
    d_ff=1408,
    d_ff_expert=1408,
    vocab=151936,
    n_experts=60,           # padded to 64 for 16-way EP
    top_k=4,
    n_shared_experts=4,
    qkv_bias=True,
    rope_theta=1e6,
)
