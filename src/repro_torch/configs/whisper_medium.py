"""Whisper-medium backbone. [arXiv:2212.04356; unverified]
24+24L d_model=1024 16H (MHA) d_ff=4096 vocab=51865; enc-dec.
Conv audio frontend is a STUB: input_specs provides 1500 precomputed
frame embeddings; the shape's seq_len drives the decoder."""
from repro_torch.models.common import ModelConfig

config = ModelConfig(
    name="whisper-medium",
    family="encdec",
    n_layers=24,
    n_encoder_layers=24,
    encoder_ctx=1500,
    d_model=1024,
    n_heads=16,
    n_kv=16,
    d_head=64,
    d_ff=4096,
    vocab=51865,
    rope_theta=1e4,
)
