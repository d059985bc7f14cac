"""pixtral-12b [vlm] — pixtral-ViT frontend (stub) + mistral-nemo backbone
[hf:mistralai/Pixtral-12B-2409].

The modality frontend is a STUB per the assignment: ``input_specs`` supplies
precomputed patch embeddings which the backbone projects and prepends to the
text token embeddings.
"""
from repro_torch.configs.base import ModelConfig, VLMConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=131072,
    head_dim=128,
    rope_theta=1000000.0,
    vlm=VLMConfig(n_patches=256, patch_dim=1024),
    microbatches=8,
)
