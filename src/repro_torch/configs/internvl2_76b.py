"""InternVL2-Llama3-76B backbone. [arXiv:2404.16821; unverified]
80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256.
InternViT frontend is a STUB: input_specs provides 256 patch embeddings
per image, prepended to the text sequence."""
import torch

from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="internvl2-76b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv=8,
    d_head=128,
    d_ff=28672,
    vocab=128256,
    n_img_tokens=256,
    rope_theta=5e5,
    param_dtype=torch.bfloat16,
    compute_dtype=torch.bfloat16,
)
