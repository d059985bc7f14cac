"""Step-indexed generation over a mesh of devices (paper App. 10).

One generation step draws ``edges_per_device`` edges on every device of a
mesh with no collective: device *i* descends under its own key
``fold_in(PRNGKey(0), seeds[i])`` (``split`` into L level keys, one
``uniform`` per level — the ``reference`` backend's ``sample_parts``)
and prepends *i* as a src-id prefix above its ``n`` suffix levels, so the
devices' id ranges are disjoint.  The JAX package runs the same step as a
``shard_map`` over a TPU mesh; here the mesh is a sequence of torch
devices whose length is a power of two (entries may repeat a card: the
devices of one card then run in turn).  ``device_mesh`` is the mesh a
job takes: every visible card, or the one CPU.
``datastream.DeviceStepShardSource`` drives one step per shard;
``step_seeds`` makes every step re-runnable in isolation.

``build_generation_cell`` is the dry-run's graph-generation cell (the JAX
package's): one step of the trillion-edge configuration (2^30 × 2^30
nodes, 2^24 edges a device) over a mesh of any size, its work per device
that of the R-MAT kernel the step runs (K2's operations and id bytes for
``threefry``; K3's uniform and id bytes for ``hbm_uniforms``), and no
collective.  Its ``fn`` runs that step over a sequence of devices.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core.descend import (as_torch_dtype, check_id_capacity,
                                      combine_ids_device)
from repro_torch.core.sampler import get_backend
from repro_torch.kernels import bounds
from repro_torch.kernels import rmat_sample as rs


def device_mesh(device="cuda") -> List[torch.device]:
    """The mesh a step spans on ``device``'s kind: every visible card
    (``cuda:0 .. cuda:k-1``), or the one CPU."""
    dev = torch.device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def mesh_bits(n_dev: int) -> int:
    """``log2(n_dev)``: the src levels a mesh of ``n_dev`` devices takes
    as its device prefix."""
    k = int(n_dev).bit_length() - 1
    if n_dev < 1 or 2 ** k != n_dev:
        raise ValueError(f"device count {n_dev} must be a power of two")
    return k


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
                    mesh: Optional[Sequence] = None, dtype=torch.int32,
                    device="cuda", backend: str = "reference",
                    uniforms=None):
    """One step over ``mesh`` (default: the one device ``device``):
    ``(src, dst)`` ids of shape ``(n_dev, edges_per_device)`` in
    ``dtype`` on ``mesh[0]``, row *i* drawn on ``mesh[i]`` under
    ``seeds[i]``.  ``n`` is the src suffix levels below the device prefix
    (``log2(n_dev)`` bits), ``m`` the dst levels; ``thetas`` is the full
    ``(L, 4)`` table, of which the descend reads ``max(n, m)`` rows.
    ``backend``: the sampler each device draws with (``reference``, the
    JAX package's stream; ``cuda_prng``, K2's); ``uniforms`` ``(n_dev, L,
    E)``: draw from these instead (K3, the JAX package's
    ``hbm_uniforms`` mode)."""
    mesh = [torch.device(d) for d in
            (mesh if mesh is not None else [device])]
    n_dev = len(mesh)
    k_pref = mesh_bits(n_dev)
    seeds = np.asarray(seeds).reshape(-1)
    if len(seeds) != n_dev:
        raise ValueError(f"a step over {n_dev} device(s) takes {n_dev} "
                         f"seeds, got {len(seeds)}")
    dt = as_torch_dtype(dtype)
    # device prefix bits + level bits must fit the id dtype
    check_id_capacity(n + k_pref, dt,
                      "device_generate: device prefix + src level bits")
    check_id_capacity(m, dt, "device_generate: dst level bits")
    sampler = get_backend(backend)
    rows_s, rows_d = [], []
    for i, dev in enumerate(mesh):
        if uniforms is not None:
            sp, dp = rs.rmat_sample_uniforms(
                torch.as_tensor(thetas, dtype=torch.float32, device=dev),
                uniforms[i].to(dev), n, m)
        else:
            key = trandom.fold_in(trandom.PRNGKey(0), int(seeds[i]))
            sp, dp = sampler.sample_parts(key, thetas, n, m,
                                          edges_per_device, dev)
            sp, dp = (type(p)(*(None if w is None else w[:edges_per_device]
                                for w in p)) for p in (sp, dp))
        didx = torch.tensor(i, dtype=torch.int32, device=dev)
        rows_s.append(combine_ids_device(sp, n, dt, prefix=didx))
        rows_d.append(combine_ids_device(dp, m, dt))
    home = mesh[0]
    return (torch.stack([r.to(home) for r in rows_s]),
            torch.stack([r.to(home) for r in rows_d]))


class GenCell(NamedTuple):
    fn: Any              # fn(thetas, seeds[, uniforms]) over ``devices``
    args: tuple          # per-device TensorSpecs of the arguments
    meta: dict           # the reference's: edges, target_edges, ...
    costs: dict          # per-device work and bytes of the step


def build_generation_cell(mesh, scale: str = "1t",
                          edges_per_device: int = 1 << 24,
                          mode: str = "threefry",
                          devices: Optional[Sequence] = None) -> GenCell:
    """One streaming step of the trillion-edge dry run on ``mesh`` (a
    ``DeviceMesh``, a sequence of devices, or a device count).

    The device prefix is part of the 2^30 src id space (the top
    ``log2(n_dev)`` src levels), so ids fit int32 on any mesh.  ``fn``
    runs the step over ``devices`` (default: the one card): ``threefry``
    through K2 (``cuda_prng``), ``hbm_uniforms`` through K3 from
    pre-drawn uniforms."""
    from repro_torch.models.params import TensorSpec
    size = (mesh if isinstance(mesh, int) else
            mesh.size() if hasattr(mesh, "size") else len(mesh))
    m = 30          # 2^30 nodes a partite (total, across the mesh)
    n = m - mesh_bits(size)   # each device's src suffix levels
    L = max(n, m)
    E = edges_per_device
    total = {"1t": 1.0e12, "100b": 1.0e11}.get(scale, 1.0e12)
    step_edges = E * size
    meta = {"edges": step_edges, "target_edges": total,
            "steps_needed": int(np.ceil(total / step_edges)), "mode": mode}
    args = (TensorSpec((L, 4), torch.float32), TensorSpec((1,), torch.int32))
    out_bytes = 2 * 4 * E
    if mode == "hbm_uniforms":
        args += (TensorSpec((1, L, E), torch.float32),)
        costs = {"operations": 0, "operations_s": 0.0,
                 "bytes": float((4 * L + 8) * E),
                 "bytes_s": bounds.bits_bound_s(L, E),
                 "kernel": "rmat_sample_uniforms (K3)"}
    elif mode == "threefry":
        costs = {"operations": float(L * E * bounds.PRNG_INT_OPS_PER_LEVEL),
                 "operations_s": bounds.prng_bound_s(L, E),
                 "bytes": float(out_bytes),
                 "bytes_s": out_bytes / bounds.HBM_BYTES_PER_S,
                 "kernel": "rmat_sample_prng (K2)"}
    else:
        raise ValueError(f"unknown generation mode {mode!r}")
    costs.update(argument_bytes=sum(
        int(np.prod(a.shape)) * 4 for a in args), output_bytes=out_bytes)

    def step(thetas, seeds, uniforms=None):
        devs = list(devices) if devices is not None else ["cuda"]
        return device_generate(thetas, seeds, n, m, E, devs,
                               backend="cuda_prng", uniforms=uniforms)

    return GenCell(step, args, meta, costs)
