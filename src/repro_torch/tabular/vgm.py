"""Mode-specific normalization (paper §3.3, following CTGAN): per-column
Gaussian mixtures that encode a value as (mode, α) and decode it back.

``fit_vgm`` (EM for a 1-D mixture with mode pruning) and ``transform``
run on the host in numpy, as the JAX package runs them, so a fit gives
the reference's arrays bit for bit.  ``inverse`` maps (mode, α) back to
a value on the device of its inputs.
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


def fit_vgm(x: np.ndarray, n_modes: int = 5, n_iter: int = 50,
            weight_floor: float = 0.005, seed: int = 0) -> VGMParams:
    """EM for a 1-D GMM with mode pruning: modes start at the column's
    5–95% quantiles (jittered by ``default_rng(seed)``); modes whose
    weight ends at or below ``weight_floor`` are inactive."""
    x = np.asarray(x, np.float64).reshape(-1)
    rng = np.random.default_rng(seed)
    n = x.size
    qs = np.quantile(x, np.linspace(0.05, 0.95, n_modes))
    means = qs + rng.normal(0, 1e-3, n_modes)
    stds = np.full(n_modes, max(x.std(), 1e-3))
    weights = np.full(n_modes, 1.0 / n_modes)
    for _ in range(n_iter):
        # E step
        logp = (-0.5 * ((x[:, None] - means[None]) / stds[None]) ** 2
                - np.log(stds[None]) + np.log(weights[None] + 1e-12))
        logp -= logp.max(axis=1, keepdims=True)
        r = np.exp(logp)
        r /= r.sum(axis=1, keepdims=True)
        # M step
        nk = r.sum(axis=0) + 1e-9
        weights = nk / n
        means = (r * x[:, None]).sum(axis=0) / nk
        stds = np.sqrt((r * (x[:, None] - means[None]) ** 2).sum(axis=0) / nk)
        stds = np.maximum(stds, 1e-4 * max(x.std(), 1e-3))
    active = weights > weight_floor
    if not active.any():
        active[np.argmax(weights)] = True
    return VGMParams(weights=weights, means=means, stds=stds, active=active)


def transform(params: VGMParams, x: np.ndarray
              ) -> Tuple[np.ndarray, np.ndarray]:
    """x -> (mode ids (N,) int32, normalized scalar (N,) float32 clipped to
    ±1), the most likely active mode per value."""
    x = np.asarray(x, np.float64).reshape(-1)
    logp = (-0.5 * ((x[:, None] - params.means[None]) / params.stds[None]) ** 2
            - np.log(params.stds[None])
            + np.log(params.weights[None] + 1e-12))
    logp[:, ~params.active] = -np.inf
    mode = logp.argmax(axis=1)
    alpha = (x - params.means[mode]) / (4.0 * params.stds[mode])
    return mode.astype(np.int32), np.clip(alpha, -1, 1).astype(np.float32)


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
