"""Mode-specific normalization (paper §3.3, following CTGAN): the fitted
per-column Gaussian mixtures that decode a GAN row back to a value.

Fitting stays in the JAX package; a fit crosses over as its arrays
(``repro_torch.convert``).  ``inverse`` maps (mode, α) back to a value.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import numpy as np
import torch


@dataclasses.dataclass
class VGMParams:
    weights: np.ndarray    # (K,)
    means: np.ndarray      # (K,)
    stds: np.ndarray       # (K,)
    active: np.ndarray     # (K,) bool — pruned modes excluded from sampling

    @property
    def n_modes(self) -> int:
        return len(self.weights)


def stack_params(vgms: Sequence[VGMParams], n_cont: int, n_modes: int
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Stack per-column parameters into dense (n_cont, K) arrays for the
    batched decode engine (``repro_torch.core.feature_engine``)."""
    means = np.zeros((n_cont, n_modes), np.float32)
    stds = np.ones((n_cont, n_modes), np.float32)
    active = np.zeros((n_cont, n_modes), bool)
    for j, p in enumerate(vgms):
        means[j] = p.means
        stds[j] = p.stds
        active[j] = p.active
    return means, stds, active


def inverse(params: VGMParams, mode: torch.Tensor, alpha: torch.Tensor
            ) -> torch.Tensor:
    """``means[mode] + α·4·stds[mode]`` in float64, returned as float32."""
    dev = mode.device
    means = torch.as_tensor(params.means, dtype=torch.float64, device=dev)
    stds = torch.as_tensor(params.stds, dtype=torch.float64, device=dev)
    mode = mode.to(torch.int64)
    return (means[mode] + alpha.to(torch.float64) * 4.0 * stds[mode]
            ).to(torch.float32)
