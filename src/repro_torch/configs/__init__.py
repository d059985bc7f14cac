"""Architecture registry of the port.

``get_config(name)`` returns the exact published configuration, as the JAX
package's ``repro.configs.get_config`` does; ``all_configs()`` every one
of them.  The registry holds the reference's ten architectures: the dense
LMs and the moe, vlm, hybrid, ssm (RWKV6) and encdec families.
"""
from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES, SHAPES_BY_NAME, ModelConfig, MoEConfig, SSMConfig,
    HybridConfig, RWKVConfig, EncDecConfig, VLMConfig, ShapeSpec,
)

ARCHS: List[str] = [
    "tinyllama_1_1b",
    "llama3_8b",
    "glm4_9b",
    "stablelm_1_6b",
    "pixtral_12b",
    "qwen3_moe_30b_a3b",
    "llama4_scout_17b_16e",
    "zamba2_1_2b",
    "seamless_m4t_medium",
    "rwkv6_7b",
]

_ALIASES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3-8b": "llama3_8b",
    "glm4-9b": "glm4_9b",
    "stablelm-1.6b": "stablelm_1_6b",
    "pixtral-12b": "pixtral_12b",
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_16e",
    "llama4-scout-17b-16e": "llama4_scout_17b_16e",
    "zamba2-1.2b": "zamba2_1_2b",
    "seamless-m4t-medium": "seamless_m4t_medium",
    "rwkv6-7b": "rwkv6_7b",
}


def get_config(name: str) -> ModelConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG


def all_configs() -> Dict[str, ModelConfig]:
    return {a: get_config(a) for a in ARCHS}
