"""seamless-m4t-medium [audio] — encoder-decoder multimodal backbone
[arXiv:2308.11596].  Audio frontend is a STUB: input_specs supplies
precomputed frame embeddings for the encoder.
"""
from repro_torch.configs.base import ModelConfig, EncDecConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,               # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    head_dim=64,
    rope_theta=10000.0,
    encdec=EncDecConfig(n_encoder_layers=12, encoder_frac=0.5),
    microbatches=2,
)
