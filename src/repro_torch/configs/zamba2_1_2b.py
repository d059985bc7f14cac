"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention blocks
[arXiv:2411.15242].  ssm_state=64."""
from repro_torch.configs.base import ModelConfig, SSMConfig, HybridConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    rope_theta=10000.0,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64, chunk=128),
    hybrid=HybridConfig(attn_every=6),
    microbatches=4,
)
