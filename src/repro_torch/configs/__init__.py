"""Architecture registry of the port.

``get_config(name)`` returns the exact published configuration, as the JAX
package's ``repro.configs.get_config`` does.  The registry lists only the
families the port runs: the dense LMs.  The others (moe, vlm, hybrid, ssm,
encdec) wait for their port (ROADMAP A7(b)).
"""
from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import (  # noqa: F401
    LM_SHAPES, SHAPES_BY_NAME, ModelConfig, MoEConfig, SSMConfig,
    HybridConfig, RWKVConfig, EncDecConfig, VLMConfig, ShapeSpec,
)

ARCHS: List[str] = [
    "tinyllama_1_1b",
    "llama3_8b",
    "glm4_9b",
    "stablelm_1_6b",
]

_ALIASES = {
    "tinyllama-1.1b": "tinyllama_1_1b",
    "llama3-8b": "llama3_8b",
    "glm4-9b": "glm4_9b",
    "stablelm-1.6b": "stablelm_1_6b",
}


def get_config(name: str) -> ModelConfig:
    key = _ALIASES.get(name, name).replace("-", "_").replace(".", "_")
    if key not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port runs: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{key}")
    return mod.CONFIG
