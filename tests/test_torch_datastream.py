"""The port's ``datastream`` against the JAX package's, on the CPU.

Both packages write the same sharded format.  What is held and how:

* the plan (``ChunkScheduler``): equal — k_pref, chunks, shard packing,
  worker queues, θ to the last digit and its digest;
* struct-only datasets: byte-identical, every ``.npy`` file and
  ``manifest.json``, for the ``xla`` stream (``reference``) and the
  ``pallas_bits`` stream (the JAX kernel in interpret mode against the
  port's ``cuda_bits``/``cuda_prng`` plain versions), int32 and int64
  ids, executor depth 0 and 2, ``chunks`` and ``device_steps`` mode; a
  job stopped by one package and resumed by the other ends byte-identical
  to an uninterrupted run;
* inside the port: resumes after a kill, a torn journal line or a lost
  shard; the deep verify, the writer's crc, the pump, ``compact_subgraph``.

Featured datasets are held in ``tests/test_torch_datastream_features.py``
(inside the port) and ``tests/test_torch_datastream_carried.py`` (against
the JAX package, with the executor's fake-stage and command-line tests).

The port's CUDA backends run their kernels' plain versions here; the
card test is in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import hashlib
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.structure import KroneckerFit as JFit
from repro.datastream import (ChunkScheduler as JScheduler,
                              DatasetJob as JJob, Manifest as JManifest)
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (ChunkScheduler, DatasetJob, Manifest,
                                    ShardedGraphDataset, ShardWriter,
                                    auto_k_pref, pump_chunks)
from repro_torch.datastream.writer import JOURNAL_NAME

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"
THETA = dict(a=0.45, b=0.22, c=0.2, d=0.13)
#: the JAX datastream tests' fit
FIT = dict(THETA, n=12, m=12, E=60_000)
#: small enough for the Pallas kernel in interpret mode; E is not a
#: multiple of the shard size, so the last shard is ragged
SMALL = dict(THETA, n=10, m=10, E=14_000)
#: ids past 31 bits: the (hi, lo) word pair
WIDE = dict(THETA, n=33, m=32, E=6_000)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch's CPU ops on one thread: these draws run about as fast on one
    as on eight, and no thread pool is left spinning when the suite runs
    several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


@pytest.fixture(autouse=True)
def _partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _hashes(path, manifest=True):
    names = [f for f in sorted(os.listdir(path)) if f.endswith(".npy")
             or (manifest and f == "manifest.json")]
    return {f: hashlib.md5(open(os.path.join(path, f), "rb").read())
            .hexdigest() for f in names}


@pytest.fixture(scope="module")
def jax_ds(tmp_path_factory):
    """Run (once per configuration) a JAX ``DatasetJob`` and return its
    directory."""
    cache = {}

    def run(fit, **kw):
        key = (tuple(sorted(fit.items())), tuple(sorted(kw.items())))
        if key not in cache:
            out = str(tmp_path_factory.mktemp("jax") / "ds")
            JJob(JFit(**fit), out, **kw).run()
            cache[key] = out
        return cache[key]

    return run


# -- the plan ----------------------------------------------------------------

def _asset_fit():
    from repro_torch import convert
    return convert.pipeline_from_state(convert.load_state(ASSET),
                                       device="cpu").struct


@pytest.mark.parametrize("case", ["fit", "fit-noise", "asset64-2^24",
                                  "asset64-1e6"])
def test_plan_matches_reference(case):
    if case.startswith("asset64"):
        tfit = _asset_fit().scaled(64)
        jfit = JFit(**dataclasses.asdict(tfit))
        shard_edges = 1 << 24 if case.endswith("2^24") else 1_000_000
        workers, seed = 1, 0
    else:
        noise = 0.03 if case == "fit-noise" else 0.0
        tfit = KroneckerFit(**FIT, noise=noise)
        jfit = JFit(**FIT, noise=noise)
        shard_edges, workers, seed = 8192, 3, 7
    t = ChunkScheduler(tfit, shard_edges=shard_edges, num_workers=workers,
                       seed=seed)
    j = JScheduler(jfit, shard_edges=shard_edges, num_workers=workers,
                   seed=seed)
    assert t.k_pref == j.k_pref == auto_k_pref(tfit, shard_edges)
    assert [tuple(c) for c in t.chunks] == [tuple(c) for c in j.chunks]
    assert [dataclasses.astuple(s) for s in t.shards] == \
        [dataclasses.astuple(s) for s in j.shards]
    assert [[float(x) for x in r] for r in t.thetas] == \
        [[float(x) for x in r] for r in j.thetas]
    assert t.theta_digest == j.theta_digest
    np.testing.assert_array_equal(t.key_for(t.chunks[-1]).numpy(),
                                  np.asarray(j.key_for(j.chunks[-1])))
    if case == "asset64-2^24":
        assert (tfit.n, tfit.m, tfit.E) == (18, 15, 163_840_000)
        assert t.k_pref == 7 and len(t.chunks) <= 4 ** 7
    elif case == "asset64-1e6":
        assert t.k_pref == 8


# -- struct-only bytes: the gate ---------------------------------------------

@pytest.mark.parametrize("fit,jbackend,backend,dtype,depth", [
    (FIT, "xla", "reference", "int32", 0),
    (FIT, "xla", "reference", "int32", 2),
    (FIT, "xla", "reference", "int64", 2),
    (WIDE, "xla", "reference", "int64", 0),
    (SMALL, "pallas_bits", "cuda_bits", "int32", 2),
    (SMALL, "pallas_bits", "cuda_prng", "int32", 0),
    (SMALL, "pallas_bits", "cuda_prng", "int32", 2),
    (SMALL, "pallas_bits", "cuda_prng", "int64", 2),
    (WIDE, "pallas_bits", "cuda_prng", "int64", 2),
], ids=["xla-i32-d0", "xla-i32-d2", "xla-i64-d2", "xla-wide-d0",
        "bits-i32-d2", "prng-i32-d0", "prng-i32-d2", "prng-i64-d2",
        "prng-wide-d2"])
def test_struct_bytes_match_reference(tmp_path, jax_ds, fit, jbackend,
                                      backend, dtype, depth):
    shard = 8192 if fit is FIT else 4096 if fit is SMALL else 2048
    kw = dict(shard_edges=shard, seed=3, id_dtype=dtype,
              pipeline_depth=depth)
    want = jax_ds(fit, backend=jbackend, **kw)
    out = str(tmp_path / "ds")
    job = DatasetJob(KroneckerFit(**fit), out, backend=backend,
                     device="cpu", **kw)
    job.run()
    assert job.backend == jbackend and job.sampler == backend
    assert len(job.scheduler.shards) >= 2
    assert _hashes(out) == _hashes(want)
    assert ShardedGraphDataset(out).verify(deep=True) == []


@pytest.mark.parametrize("fit,dtype", [(SMALL, "int32"), (WIDE, "int64")],
                         ids=["i32", "wide"])
@pytest.mark.parametrize("group_edges", [1, 1500])
def test_chunk_groups_keep_the_bytes(tmp_path, jax_ds, monkeypatch, fit,
                                     dtype, group_edges):
    """Groups of one chunk and of several, pumped double-buffered or
    serially, write the reference's bytes."""
    from repro_torch.datastream import source as source_mod
    monkeypatch.setattr(source_mod, "PUMP_GROUP_EDGES", group_edges)
    kw = dict(shard_edges=4096 if fit is SMALL else 2048, seed=3,
              id_dtype=dtype, pipeline_depth=2)
    want = jax_ds(fit, backend="pallas_bits", **kw)
    for dbl in (True, False):
        out = str(tmp_path / f"ds-{dbl}")
        job = DatasetJob(KroneckerFit(**fit), out, backend="cuda_prng",
                         device="cpu", double_buffered=dbl, **kw)
        sched = job.scheduler
        sizes = [len(g) for rec in sched.shards for g in
                 source_mod._chunk_groups(
                     [sched.chunk(i) for i in rec.chunk_indices],
                     group_edges)]
        assert max(sizes) == 1 if group_edges == 1 else max(sizes) > 1
        job.run()
        assert _hashes(out) == _hashes(want)


@pytest.mark.parametrize("depth", [0, 2])
def test_device_steps_bytes_match_reference(tmp_path, jax_ds, depth):
    assert len(jax.devices()) == 1
    kw = dict(shard_edges=16_384, seed=1, mode="device_steps",
              pipeline_depth=depth)
    want = jax_ds(FIT, **kw)
    out = str(tmp_path / "ds")
    DatasetJob(KroneckerFit(**FIT), out, device="cpu", **kw).run()
    assert Manifest.load(out).n_dev == 1
    assert Manifest.load(out).backend == "device_descend_v2"
    assert _hashes(out) == _hashes(want)


def test_device_generate_matches_reference():
    from jax.sharding import Mesh

    from repro.core import distributed_gen as jdg
    from repro_torch.core import distributed_gen as dg
    for base, step in ((0, 0), (7, 3), (2 ** 40 + 5, 11)):
        np.testing.assert_array_equal(dg.step_seeds(base, step, 4),
                                      jdg.step_seeds(base, step, 4))
    th = np.random.default_rng(0).dirichlet(np.ones(4), 11)
    seeds = dg.step_seeds(5, 2, 1)
    mesh = Mesh(np.array(jax.devices()[:1]), ("d",))
    js, jd = jdg.device_generate(jax.numpy.asarray(th, jax.numpy.float32),
                                 jax.numpy.asarray(seeds), 11, 9, 3000, mesh)
    s, d = dg.device_generate(th, seeds, 11, 9, 3000, device="cpu")
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


# -- resume across packages --------------------------------------------------

@pytest.mark.parametrize("first", ["jax", "port"])
def test_cross_package_resume(tmp_path, jax_ds, first):
    kw = dict(shard_edges=8192, seed=0, pipeline_depth=2)
    full = jax_ds(FIT, backend="xla", **kw)
    out = str(tmp_path / "ds")
    port = lambda: DatasetJob(KroneckerFit(**FIT), out,  # noqa: E731
                              backend="reference", device="cpu", **kw)
    ref = lambda: JJob(JFit(**FIT), out, backend="xla", **kw)  # noqa: E731
    (ref if first == "jax" else port)().run(max_shards=3)
    m = (JManifest if first == "jax" else Manifest).load(out)
    assert len(m.done_ids()) == 3 and not m.is_complete()
    before = _hashes(out, manifest=False)
    m2 = (port if first == "jax" else ref)().resume()
    assert m2.is_complete()
    after = _hashes(out)
    assert all(after[f] == h for f, h in before.items())
    assert after == _hashes(full)
    # each package verifies what the other finished
    assert ShardedGraphDataset(out).verify(deep=True) == []
    from repro.datastream import ShardedGraphDataset as JDataset
    assert JDataset(out).verify(deep=True) == []


# -- resume inside the port --------------------------------------------------

def _tjob(out, fit=FIT, **kw):
    kw = dict(dict(shard_edges=8192, seed=0, backend="reference",
                   device="cpu"), **kw)
    return DatasetJob(KroneckerFit(**fit), out, **kw)


def test_kill_and_resume_with_torn_journal(tmp_path):
    full, part = str(tmp_path / "full"), str(tmp_path / "part")
    _tjob(full).run()
    _tjob(part).run(max_shards=3)
    with pytest.raises(RuntimeError, match="incomplete"):
        ShardedGraphDataset(part)
    # a kill mid-append leaves a torn journal line behind the compacted
    # manifest: replay skips it
    with open(os.path.join(part, JOURNAL_NAME), "ab") as f:
        f.write(b'{"shard_id": 3, "stem": "shard-000')
    assert Manifest.load(part).done_ids() == [0, 1, 2]
    before = _hashes(part, manifest=False)
    assert _tjob(part).resume().is_complete()
    after = _hashes(part)
    assert all(after[f] == h for f, h in before.items())
    assert after == _hashes(full)
    assert os.path.getsize(os.path.join(part, JOURNAL_NAME)) == 0


def test_journal_replay_recovers_uncompacted_progress(tmp_path):
    out = str(tmp_path / "ds")
    job = _tjob(out)
    manifest = job.plan()
    writer = ShardWriter(out, manifest, checkpoint_every=10_000)
    writer.write_shard(0, job.source.generate(manifest.shards[0]))
    raw = json.load(open(os.path.join(out, "manifest.json")))
    assert all(s["status"] == "pending" for s in raw["shards"])
    assert Manifest.load(out).done_ids() == [0]
    assert _tjob(out).resume().is_complete()
    assert ShardedGraphDataset(out).verify(deep=True) == []


def test_resume_regenerates_corrupted_shard(tmp_path):
    out = str(tmp_path / "ds")
    _tjob(out).run(max_shards=2)
    victim = Manifest.load(out).shards[0].files["src"]
    before = _hashes(out, manifest=False)
    os.remove(os.path.join(out, victim))
    assert _tjob(out).resume().is_complete()
    assert ShardedGraphDataset(out).verify(deep=True) == []
    assert _hashes(out, manifest=False)[victim] == before[victim]


def test_resume_refuses_mismatched_config(tmp_path):
    out = str(tmp_path / "ds")
    _tjob(out).run(max_shards=1)
    with pytest.raises(ValueError, match="different"):
        _tjob(out, seed=1).resume()
    with pytest.raises(ValueError, match="backend"):
        _tjob(out, backend="cuda_prng").resume()
    with pytest.raises(ValueError, match="dtype"):
        _tjob(out, id_dtype="int64").resume()
    with pytest.raises(FileExistsError):
        _tjob(out).run()


def test_job_refuses_missing_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = str(tmp_path / "ds")
    with pytest.raises(ValueError, match="no CUDA card"):
        DatasetJob(KroneckerFit(**FIT), out)
    assert not os.path.exists(out)


def test_deep_verify_catches_a_flipped_byte(tmp_path, monkeypatch):
    from repro_torch.datastream import writer as writer_mod
    out = str(tmp_path / "ds")
    _tjob(out).run()
    monkeypatch.setattr(writer_mod, "CRC_BLOCK_ROWS", 1000)
    assert ShardedGraphDataset(out).verify(deep=True) == []
    path = os.path.join(out, Manifest.load(out).shards[0].files["dst"])
    with open(path, "r+b") as f:
        f.seek(-1, os.SEEK_END)
        last = f.read(1)[0]
        f.seek(-1, os.SEEK_END)
        f.write(bytes([last ^ 0xFF]))
    ds = ShardedGraphDataset(out)
    assert ds.verify(deep=False) == []
    assert any("shard 0" in p for p in ds.verify(deep=True))


@pytest.mark.parametrize("arr", [
    np.arange(10_007, dtype=np.int64),
    np.arange(33, dtype=np.int32).reshape(11, 3) * 7,
    np.zeros((0,), np.float32),
    np.random.default_rng(0).normal(size=(5000, 4)).astype(np.float32),
], ids=["int64-1d", "int32-2d", "empty", "f32-2d"])
def test_save_crc_matches_np_save_and_reference(tmp_path, arr):
    import zlib

    from repro.datastream.writer import _crc32_stream as jcrc
    from repro_torch.datastream.writer import (_atomic_save_npy_crc,
                                               _crc32_stream)
    path = str(tmp_path / "a.npy")
    crc = _atomic_save_npy_crc(path, arr, block_bytes=64)
    np.save(str(tmp_path / "b.npy"), arr)
    assert open(path, "rb").read() == open(tmp_path / "b.npy", "rb").read()
    assert not os.path.exists(path + ".tmp")
    assert crc == zlib.crc32(arr.tobytes()) == _crc32_stream(arr, 7) \
        == jcrc(arr, 5)


# -- the pump and the graph substrate ----------------------------------------

def test_pump_chunks_order_and_completeness():
    items = list(range(7))
    for dbl in (True, False):
        flushed = []
        n = pump_chunks(items, dispatch=lambda i: torch.full((3,), i),
                        flush=lambda i, host: flushed.append(
                            (i, int(host.sum()))),
                        double_buffered=dbl, device="cpu")
        assert n == 7
        assert flushed == [(i, 3 * i) for i in items]


@pytest.mark.parametrize("bipartite", [True, False])
def test_compact_subgraph_matches_reference(bipartite):
    from repro.graph.ops import compact_subgraph as jcompact
    from repro_torch.graph.ops import compact_subgraph
    rng = np.random.default_rng(1)
    src = (rng.integers(0, 1 << 20, 3000) * 7).astype(np.int64)
    dst = rng.integers(0, 1 << 12, 3000).astype(np.int64)
    want = jcompact(src, dst, bipartite)
    got = compact_subgraph(torch.from_numpy(src), torch.from_numpy(dst),
                           bipartite)
    assert got.src.dtype == torch.int32
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
    assert (got.n_src, got.n_dst, got.bipartite) == (want.n_src, want.n_dst,
                                                     want.bipartite)
