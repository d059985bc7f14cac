"""Step-indexed generation on one card (paper App. 10, one device).

The JAX package runs one generation step as a ``shard_map`` over a TPU
mesh: device *i* samples ``edges_per_device`` edges under its own seed,
with the device index as a src-id prefix, and no collective.  On one card
the mesh has one device: there is no prefix, and a step is a single
descend whose stream is ``split(fold_in(PRNGKey(0), seed), L)`` with one
``uniform`` per level — the ``reference`` backend's ``sample_parts`` on
that key.  ``datastream.DeviceStepShardSource`` drives one step per
shard; ``step_seeds`` makes every step re-runnable in isolation.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.descend import (as_torch_dtype, check_id_capacity,
                                      combine_ids)
from repro_torch.core.sampler import get_backend

#: devices of a single-card step (the mesh size the manifest records)
N_DEV = 1


def step_seeds(base_seed: int, step: int, n_dev: int) -> np.ndarray:
    """Step-indexed per-device seeds (splitmix64 finalizer, int32 range).

    Deterministic in ``(base_seed, step)`` and disjoint across devices and
    steps: step *s* can be (re)run in isolation — after a crash, in any
    order — and produce the same edges, which is what
    ``datastream.DatasetJob`` resumption relies on."""
    with np.errstate(over="ignore"):   # uint64 wraparound is the point
        mix = (np.uint64(base_seed) * np.uint64(0x9E3779B97F4A7C15)
               + np.uint64(step) * np.uint64(0xBF58476D1CE4E5B9)
               + np.arange(n_dev, dtype=np.uint64) *
               np.uint64(0x94D049BB133111EB))
        mix ^= mix >> np.uint64(30)
        mix *= np.uint64(0xBF58476D1CE4E5B9)
        mix ^= mix >> np.uint64(27)
        mix *= np.uint64(0x94D049BB133111EB)
        mix ^= mix >> np.uint64(31)
    return (mix & np.uint64(0x7FFFFFFF)).astype(np.int32)


def device_generate(thetas, seeds, n: int, m: int, edges_per_device: int,
                    dtype=torch.int32, device="cuda"):
    """One step on one card: ``(src, dst)`` ids of shape
    ``(1, edges_per_device)`` in ``dtype`` on ``device``.  ``thetas`` is
    the full ``(max(n, m), 4)`` table, ``seeds`` the step's one seed."""
    seeds = np.asarray(seeds).reshape(-1)
    if len(seeds) != N_DEV:
        raise ValueError(f"a single-card step takes {N_DEV} seed, got "
                         f"{len(seeds)}")
    dt = as_torch_dtype(dtype)
    check_id_capacity(n, dt, "device_generate: src level bits")
    check_id_capacity(m, dt, "device_generate: dst level bits")
    key = trandom.fold_in(trandom.PRNGKey(0), int(seeds[0]))
    sp, dp = get_backend("reference").sample_parts(
        key, thetas, n, m, edges_per_device, torch.device(device))
    return combine_ids(sp, n, dt)[None], combine_ids(dp, m, dt)[None]
