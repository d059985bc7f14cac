"""rwkv6-7b (Finch) [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892]."""
from repro_torch.configs.base import ModelConfig, RWKVConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # wkv heads = d_model / head_dim
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    head_dim=64,
    # chunk=32: the GLA-style exp(±cum) factorization must keep
    # |cum| <= chunk*DECAY_CLAMP < 88 in f32 (see models/rwkv.py)
    rwkv=RWKVConfig(head_dim=64, chunk=32, decay_lora=64),
    microbatches=8,
)
