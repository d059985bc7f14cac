"""Paper Fig. 8: generator throughput (edges/s).

Sweeps every backend of the port's edge-sampler engine
(``repro_torch.core.sampler``) through the one shared contract,
``backend.sample(key, thetas, n, m, n_edges, device=)``, and reports
edges/s per backend beside the H100's bound for the same work, plus the
bound rows of the two kernels (bits read from memory against bits made
in registers).

Renamed from ``benchmarks/fig8_throughput.py``: the backends ``xla`` →
``reference``, ``pallas_bits`` → ``cuda_bits`` (K1) and ``pallas_prng`` →
``cuda_prng`` (K2), with their edge counts; the rows
``v5e_kernel_bits_roofline`` and ``v5e_kernel_prng_roofline`` →
``h100_kernel_bits_bound`` and ``h100_kernel_prng_bound``; the 256-chip
pod row is gone (one card).  The interpret-mode gating and its
``--interpret`` flag are gone: a CUDA backend with no card is not timed
and its row reads ``not timed: unavailable: <why_unavailable()>``.

A timed row's derived field carries ``eps`` (edges/s) and, on the card,
``bound_eps`` (the H100's bound: K1's bytes for ``cuda_bits``, K2's threefry operations
for ``cuda_prng`` and ``reference``, which draws the same words) and
``of_bound`` (bound time over measured time, at most 1 unless a timed
call did not end on the device).

Emits ``results/bench_torch/BENCH_fig8.json`` (one row per backend)
beside ``results/bench_torch/fig8_throughput.json``.
"""
from __future__ import annotations

import time

import numpy as np

from repro_torch import random as trandom
from repro_torch.benchmarks.common import (device_of, emit, emit_bench, row,
                                           sync)
from repro_torch.core import sampler
from repro_torch.kernels.bounds import (HBM_BYTES_PER_S, bits_bound_s,
                                        prng_bound_s, prng_kernel_bound_s)

#: levels and θ of the sweep (the JAX module's)
N_LEVELS = 24
THETA = [0.45, 0.22, 0.2, 0.13]

#: per-backend edge counts, the JAX module's under the port's names
E_FAST = {"reference": 1 << 18, "cuda_bits": 1 << 16, "cuda_prng": 1 << 20}
E_FULL = {"reference": 1 << 21, "cuda_bits": 1 << 17, "cuda_prng": 1 << 24}


def thetas() -> np.ndarray:
    return np.tile(np.asarray(THETA, np.float32), (N_LEVELS, 1))


def bound_s(name: str, n_edges: int) -> float:
    """The H100's least time for ``name``'s work on ``n_edges`` edges."""
    if name == "cuda_bits":
        return bits_bound_s(N_LEVELS, n_edges)
    return prng_kernel_bound_s(N_LEVELS, n_edges)


def _time_backend(be, th, E, dev) -> float:
    be.sample(trandom.PRNGKey(0), th, N_LEVELS, N_LEVELS, E, device=dev)
    sync(dev)                                     # after the warm-up call
    t0 = time.perf_counter()
    be.sample(trandom.PRNGKey(1), th, N_LEVELS, N_LEVELS, E, device=dev)
    sync(dev)
    return time.perf_counter() - t0


def run(fast: bool = True, device="cuda"):
    dev = device_of(device)
    th = thetas()
    sizes = E_FAST if fast else E_FULL
    rows = []
    for name in sampler.registered_backends():
        be = sampler.get_backend(name)
        reason = be.why_unavailable()
        if dev.type == "cpu" and name != "reference":
            # on CPU tensors the CUDA backends take their plain versions:
            # timing those says nothing of the kernel
            reason = reason or "a CUDA kernel; --device cpu times its " \
                "plain version only"
        if reason is not None:
            rows.append(row(f"fig8/{name}", 0.0,
                            f"not timed: unavailable: {reason}"))
            continue
        E = sizes[name]
        dt = _time_backend(be, th, E, dev)
        derived = f"eps={E / dt:.3e}"
        if dev.type == "cuda":        # a CPU time is not held to the card
            b = bound_s(name, E)
            derived += f";bound_eps={E / b:.3e};of_bound={b / dt:.4f}"
        rows.append(row(f"fig8/{name}", dt * 1e6, derived))

    L = N_LEVELS
    eps_bits = 1.0 / bits_bound_s(L, 1)
    eps_prng_mem = HBM_BYTES_PER_S / 8           # write two int32 ids
    eps_prng_ops = 1.0 / prng_bound_s(L, 1)
    rows.append(row("fig8/h100_kernel_bits_bound", 0.0,
                    f"eps={eps_bits:.3e} (memory-bound, 4L+8 B/edge)"))
    rows.append(row("fig8/h100_kernel_prng_bound", 0.0,
                    f"eps={min(eps_prng_mem, eps_prng_ops):.3e} "
                    f"(min of mem {eps_prng_mem:.2e}, "
                    f"ops {eps_prng_ops:.2e})"))
    out = emit(rows, "fig8_throughput")
    emit_bench("fig8", rows)
    return out
