"""llama4-scout-17b-a16e [moe] — 16 experts top-1, early fusion
[hf:meta-llama/Llama-4-Scout-17B-16E]."""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,                # per-expert FFN width
    vocab=202048,
    head_dim=128,
    rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, capacity_factor=1.25, n_groups=32),
    microbatches=8,
    fsdp=True,
)
