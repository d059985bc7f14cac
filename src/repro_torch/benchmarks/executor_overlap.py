"""Pipelined shard executor vs the serial loop: end-to-end rows/s to
disk at 2^20-edge shards, with and without per-shard features.

The serial loop pays ``struct + feat + align + write`` per shard; the
executor overlaps device struct sampling for shard k+1 with host feature
decode/alignment for shard k and writer flush for shard k−1, so wall
clock should approach ``max(...)`` instead of the sum.  Per-row timings
and the busy/wall overlap factor land in
``results/bench_torch/BENCH_executor.json``.

    python -m repro_torch.benchmarks.run --only executor_overlap [--full]

(``run(smoke=True)`` takes 2^14-edge shards, as the JAX module's
``--smoke`` does.)

As ``benchmarks/executor_overlap.py``, with every job's struct stage and
feature generators on ``device`` (the auto backend: K2 on the card).  The
write-path comparison takes the fused save + crc from
``repro_torch.datastream.writer``; its "legacy" side (``np.save``, a
``tobytes`` copy and a crc over it), which the port's writer never had,
is written out here.
"""
from __future__ import annotations

import io
import math
import os
import shutil
import tempfile
import time

import numpy as np

import zlib

from repro_torch.benchmarks.common import device_of, emit_bench, sync, timeit
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import DatasetJob, FeatureSpec, ShardedGraphDataset
from repro_torch.datastream.writer import (_atomic_save_npy_crc,
                                           _atomic_write_bytes)

#: (label, pipeline_depth, host_workers) — the serial baseline vs the
#: overlapped executor with a 2-deep queue and 2 host feature threads
CONFIGS = (("serial", 0, 1), ("pipelined", 2, 2))


def _fit(E: int) -> KroneckerFit:
    n = max(8, math.ceil(math.log2(max(E // 8, 16))))
    return KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=n, m=n, E=E)


def _legacy_save_crc(path: str, arr: np.ndarray) -> int:
    """The shard write before the fused pass: ``np.save`` to a temporary
    file, fsync, rename; then crc32 over a ``tobytes`` copy."""
    buf = io.BytesIO()
    np.save(buf, arr)
    _atomic_write_bytes(path, buf.getvalue())
    return zlib.crc32(arr.tobytes()) & 0xFFFFFFFF


def _feature_spec(dev) -> FeatureSpec:
    """A fitted KDE generator + random aligner: a realistic host-side
    feature stage (numpy-only, so resumable anywhere) with per-row cost
    comparable to structure sampling."""
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.features import KDEFeatureGenerator
    from repro_torch.tabular.schema import infer_schema

    rng = np.random.default_rng(0)
    cont = rng.normal(size=(4096, 4)).astype(np.float32)
    cat = rng.integers(0, 8, size=(4096, 2)).astype(np.int32)
    schema = infer_schema(cont, cat)
    gen = KDEFeatureGenerator(schema, device=dev).fit(cont, cat)
    return FeatureSpec(gen, RandomAligner(schema))


def _gan_feature_spec(dev) -> FeatureSpec:
    """A fitted GAN generator + random aligner: the *fusable* feature
    stage — ``GANFeatureGenerator.block_draw`` is traceable, so
    ``fused=True`` runs struct descent and Gumbel-max feature decode in
    one stage per block (KDE above has no per-block draw and would only
    fuse the struct half)."""
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.features import GANConfig, GANFeatureGenerator
    from repro_torch.tabular.schema import infer_schema

    rng = np.random.default_rng(0)
    cont = rng.normal(size=(4096, 4)).astype(np.float32)
    cat = rng.integers(0, 8, size=(4096, 2)).astype(np.int32)
    schema = infer_schema(cont, cat)
    gen = GANFeatureGenerator(schema, GANConfig(batch=128),
                              device=dev).fit(cont, cat, steps=5, seed=0)
    return FeatureSpec(gen, RandomAligner(schema))


def _fused_vs_staged_bench(shard_edges: int, n_shards: int, k_pref: int,
                           root: str, dev) -> dict:
    """Steady-state fused vs staged on the with-features pipelined
    config.  Each variant runs once to warm up (the decoders, the
    kernel's first launch), then the output is deleted and the SAME job
    re-runs for the timed pass."""
    fit = _fit(n_shards * shard_edges)
    res = {"edges": fit.E, "shard_edges": shard_edges, "k_pref": k_pref}
    for label, fused in (("staged", False), ("fused", True)):
        out = os.path.join(root, f"fusedcmp_{label}")
        job = DatasetJob(fit, out, shard_edges=shard_edges, seed=0,
                         k_pref=k_pref, pipeline_depth=2, host_workers=2,
                         features=_gan_feature_spec(dev), fused=fused,
                         device=dev)
        job.run()                      # warmup
        shutil.rmtree(out)
        sync(dev)
        t0 = time.perf_counter()
        job.run()                      # steady state
        dt = time.perf_counter() - t0
        assert ShardedGraphDataset(out).total_edges == fit.E
        res[label] = {"seconds": dt, "rows_per_sec": fit.E / dt,
                      **dict(job.timings)}
        print(f"executor_pipelined_gan_{label},{dt:.2f}s,"
              f"{fit.E / dt:,.0f} rows/s")
    res["speedup_fused"] = (res["staged"]["seconds"]
                            / res["fused"]["seconds"])
    print(f"executor_fused_speedup,{res['speedup_fused']:.3f},x")
    return res


def _write_path_bench(shard_edges: int, tmpdir: str) -> dict:
    """Before/after of the fused save+crc fix: the legacy shard write
    (``np.save`` + a full ``.tobytes()`` staging copy + crc32 over the
    copy — three passes per column, and the copy holds the GIL against
    the struct stage under async flush) vs the single-pass
    ``_atomic_save_npy_crc``."""
    arr = np.arange(shard_edges, dtype=np.int32)
    path = os.path.join(tmpdir, "col.npy")

    def legacy():
        return _legacy_save_crc(path, arr)

    def fused():
        return _atomic_save_npy_crc(path, arr)

    legacy_us = timeit(legacy, repeats=5, device="cpu")
    fused_us = timeit(fused, repeats=5, device="cpu")
    assert legacy() == fused()        # bit-identical digest
    res = {"rows": shard_edges, "legacy_us": round(legacy_us, 1),
           "fused_us": round(fused_us, 1),
           "speedup": round(legacy_us / max(fused_us, 1e-9), 3)}
    print(f"executor_write_path,legacy {legacy_us:.0f}us,"
          f"fused {fused_us:.0f}us,{res['speedup']:.2f}x")
    return res


def _materialize(fit, out, depth, workers, shard_edges, features, dev):
    spec = _feature_spec(dev) if features else None
    job = DatasetJob(fit, out, shard_edges=shard_edges, seed=0,
                     pipeline_depth=depth, host_workers=workers,
                     features=spec, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    job.run()
    dt = time.perf_counter() - t0
    assert ShardedGraphDataset(out).total_edges == fit.E
    return dt, dict(job.timings)


def run(fast: bool = True, smoke: bool = False, device="cuda") -> dict:
    dev = device_of(device)
    shard_edges = 1 << 14 if smoke else (1 << 20 if fast else 1 << 22)
    E = 8 * shard_edges                      # 8 shards: enough to pipeline
    fit = _fit(E)
    root = tempfile.mkdtemp(prefix="bench_executor_")
    result = {"edges": E, "shard_edges": shard_edges, "smoke": smoke,
              "configs": {label: {"pipeline_depth": d, "host_workers": w}
                          for label, d, w in CONFIGS}}
    try:
        # warmup: same chunk/batch shapes as every measured run
        _materialize(fit, os.path.join(root, "warmup"), 0, 1,
                     shard_edges, features=True, dev=dev)
        for features in (False, True):
            tag = "feat" if features else "nofeat"
            for label, depth, workers in CONFIGS:
                out = os.path.join(root, f"{label}_{tag}")
                dt, timings = _materialize(fit, out, depth, workers,
                                           shard_edges, features, dev)
                result[f"{label}_{tag}"] = {
                    "seconds": dt, "rows_per_sec": E / dt, **timings}
                print(f"executor_{label}_{tag},{dt:.2f}s,"
                      f"{E / dt:,.0f} rows/s,"
                      f"overlap {timings['overlap']:.2f}x")
            speed = (result[f"serial_{tag}"]["seconds"]
                     / result[f"pipelined_{tag}"]["seconds"])
            result[f"speedup_{tag}"] = speed
            print(f"executor_speedup_{tag},{speed:.3f},x")
        # fused vs staged on the with-features pipelined config (small
        # shards: the fused win is per-block host-round-trip removal,
        # which scales with block count)
        result["fused_vs_staged"] = _fused_vs_staged_bench(
            1 << 14, n_shards=4 if smoke else 8, k_pref=2, root=root,
            dev=dev)
        result["write_path"] = _write_path_bench(shard_edges, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit_bench("executor", result)
    return result
