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
* inside the port: serial = double-buffered = pipelined = fused = resumed
  byte for byte, with GAN features and the GBDT aligner;
* features against the JAX package (a JAX fit carried across): struct
  shards byte-identical; per shard, the unaligned draw's category ids
  equal and continuous values within 1e-5 on ≥ 99.9% of rows (the GAN's
  float sums differ from XLA's in the last ulps, and a Gumbel-max argmax
  can flip on a near-tie); aligned rows equal on ≥ 99% (rank matching
  moves a row to a neighbour slot on a near-tie) — the tolerances of
  ``tests/test_torch_pipeline.py``.

The port's CUDA backends run their kernels' plain versions here; the
card test is in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core.structure import KroneckerFit as JFit
from repro.datastream import (ChunkScheduler as JScheduler,
                              DatasetJob as JJob, Manifest as JManifest)
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (ChunkScheduler, DatasetJob,
                                    ExecutorStats, FeatureSpec, Manifest,
                                    ShardedGraphDataset, ShardExecutor,
                                    ShardRecord, ShardSource, ShardWriter,
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


def _manifest_sans_executor(path):
    with open(os.path.join(path, "manifest.json")) as f:
        d = json.load(f)
    d.pop("executor", None)
    return d


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


# -- features in the port ----------------------------------------------------

#: feature-stage fit: E is not a multiple of the shard size, and no shard
#: size divides the feature batch, so every shard ends in a padded block
FIT_FEAT = dict(THETA, n=10, m=10, E=14_000)


@pytest.fixture(scope="module")
def spec():
    """A port-fitted GAN generator + GBDT aligner on the CPU."""
    from repro_torch.core.aligner import AlignerConfig, GBDTAligner
    from repro_torch.core.features import GANConfig, GANFeatureGenerator
    from repro_torch.core.gbdt import GBDTConfig
    from repro_torch.graph.ops import Graph
    from repro_torch.tabular.schema import infer_schema
    rng = np.random.default_rng(0)
    cont = rng.normal(size=(400, 2)).astype(np.float32)
    cat = rng.integers(0, 3, size=(400, 1)).astype(np.int32)
    schema = infer_schema(cont, cat)
    gen = GANFeatureGenerator(schema, GANConfig(batch=64), device="cpu").fit(
        cont, cat, steps=5)
    g = Graph(torch.from_numpy(rng.integers(0, 64, 400).astype(np.int32)),
              torch.from_numpy(rng.integers(0, 64, 400).astype(np.int32)),
              64, 64)
    al = GBDTAligner(schema, AlignerConfig(
        gbdt=GBDTConfig(n_rounds=4, max_depth=3))).fit(g, cont, cat)
    return gen, al


def _feat_job(out, spec, **kw):
    gen, al = spec
    kw = dict(dict(shard_edges=4096, seed=0, backend="cuda_prng",
                   device="cpu",
                   features=FeatureSpec(gen, al, batch=1000)), **kw)
    return DatasetJob(KroneckerFit(**FIT_FEAT), out, **kw)


@pytest.fixture(scope="module")
def serial_feat(tmp_path_factory, spec):
    out = str(tmp_path_factory.mktemp("serial") / "ds")
    _feat_job(out, spec, pipeline_depth=0, double_buffered=False).run()
    return out


@pytest.mark.parametrize("variant", ["double_buffered", "pipelined",
                                     "fused", "fused-pipelined"])
def test_executor_variants_are_byte_identical(tmp_path, spec, serial_feat,
                                              variant):
    kw = {"double_buffered": dict(pipeline_depth=0),
          "pipelined": dict(pipeline_depth=3, host_workers=2),
          "fused": dict(pipeline_depth=0, fused=True),
          "fused-pipelined": dict(pipeline_depth=2, host_workers=2,
                                  fused=True)}[variant]
    out = str(tmp_path / "ds")
    job = _feat_job(out, spec, **kw)
    job.run()
    assert _hashes(out, manifest=False) == _hashes(serial_feat,
                                                   manifest=False)
    assert _manifest_sans_executor(out) == \
        _manifest_sans_executor(serial_feat)
    ds = ShardedGraphDataset(out)
    assert ds.verify(deep=True) == []
    meta = ds.manifest.features
    assert meta == {"n_cont": 2, "cat_cards": [3], "batch": 1000,
                    "device": "cpu", "generator_stream": "torch-gan-v1",
                    "aligner_stream": "torch-gbdt-v2"}
    for blk in ds:
        assert blk.cont.dtype == np.float32 and blk.cont.shape == \
            (blk.n_edges, 2)
        assert blk.cat.dtype == np.int32 and blk.cat.max() < 3
    t = job.timings
    # a fused source draws the rows in its struct stage
    assert (t["gen_feat_s"] == 0) == variant.startswith("fused")
    assert t["gen_align_s"] > 0
    assert t["overlap"] == pytest.approx(
        (t["gen_struct_s"] + t["gen_feat_s"] + t["gen_align_s"]
         + t["write_s"]) / t["wall_s"])


def test_device_steps_fused_equals_staged(tmp_path, spec):
    a, b = str(tmp_path / "staged"), str(tmp_path / "fused")
    _feat_job(a, spec, mode="device_steps", backend=None).run()
    _feat_job(b, spec, mode="device_steps", backend=None, fused=True).run()
    assert _hashes(a, manifest=False) == _hashes(b, manifest=False)


class _FlakyGen:
    """Wraps a fitted generator; raises on the ``fail_at``-th draw."""

    def __init__(self, inner, fail_at):
        self.inner = inner
        self.schema = inner.schema
        self.device = inner.device
        self.engine_batched = True
        self.stream_marker = inner.stream_marker
        self.fail_at = fail_at
        self.calls = 0
        self._lock = threading.Lock()

    def sample(self, rng, n, batch=None):
        with self._lock:
            self.calls += 1
            boom = self.calls == self.fail_at
        if boom:
            raise RuntimeError("injected feature-stage failure")
        return self.inner.sample(rng, n, batch=batch)


def test_pipelined_failure_leaves_prefix_and_resumes(tmp_path, spec,
                                                     serial_feat):
    gen, al = spec
    out = str(tmp_path / "ds")
    flaky = FeatureSpec(_FlakyGen(gen, fail_at=3), al, batch=1000)
    with pytest.raises(RuntimeError, match="injected"):
        _feat_job(out, spec, features=flaky, pipeline_depth=2,
                  host_workers=2).run()
    done = Manifest.load(out).done_ids()
    assert done == list(range(len(done))) and len(done) < 4
    assert _feat_job(out, spec, pipeline_depth=2,
                     host_workers=2).resume().is_complete()
    assert _hashes(out, manifest=False) == _hashes(serial_feat,
                                                   manifest=False)


def test_featured_resume_refuses_other_settings(tmp_path, spec):
    gen, al = spec
    out = str(tmp_path / "ds")
    _feat_job(out, spec).run(max_shards=1)
    with pytest.raises(ValueError, match="features"):
        _feat_job(out, spec, features=None).resume()
    with pytest.raises(ValueError, match="features"):
        _feat_job(out, spec,
                  features=FeatureSpec(gen, al, batch=2000)).resume()


# -- features against the JAX package ---------------------------------------

def _export_module():
    spec_ = importlib.util.spec_from_file_location(
        "export_torch_state", ROOT / "scripts" / "export_torch_state.py")
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def carried(tmp_path_factory):
    """A small JAX pipeline (GAN + GBDT) fitted once, carried across, and
    both packages' ``generate_streamed`` of it (scale 2: 8 000 edges in
    shards of 3 000, the last ragged)."""
    from repro.core.aligner import AlignerConfig as JAlignerConfig
    from repro.core.gbdt import GBDTConfig
    from repro.core.pipeline import SyntheticGraphPipeline as JPipeline
    from repro.data.reference import tabformer_like
    from repro_torch import convert
    g, cont, cat = tabformer_like(n_src=256, n_dst=64, n_edges=2000)
    jpipe = JPipeline(noise=0.03, gan_steps=10,
                      aligner_cfg=JAlignerConfig(gbdt=GBDTConfig(n_rounds=10)))
    jpipe.fit(g, cont, cat)
    pipe = convert.pipeline_from_state(
        _export_module().state_from_jax_pipeline(jpipe), device="cpu")
    root = tmp_path_factory.mktemp("carried")
    kw = dict(seed=5, scale_nodes=2, shard_edges=3000)
    jds = jpipe.generate_streamed(str(root / "jax"), backend="xla", **kw)
    tds = pipe.generate_streamed(str(root / "port"), backend="reference",
                                 **kw)
    return jpipe, pipe, jds, tds, root


def _row_match(c1, k1, c2, k2) -> float:
    same_cat = (np.asarray(k1) == np.asarray(k2)).all(1)
    same_cont = np.isclose(np.asarray(c1), np.asarray(c2), rtol=1e-5,
                           atol=1e-5).all(1)
    return float((same_cat & same_cont).mean())


def test_streamed_features_match_reference(carried):
    from repro.datastream import FeatureSpec as JFeatureSpec
    jpipe, pipe, jds, tds, _ = carried
    assert tds.total_edges == jds.total_edges == 8000 and len(tds) == 3
    for jb, tb in zip(jds, tds):
        np.testing.assert_array_equal(tb.src, jb.src)
        np.testing.assert_array_equal(tb.dst, jb.dst)
        assert tb.cont.dtype == np.float32 and tb.cat.dtype == np.int32
        assert _row_match(jb.cont, jb.cat, tb.cont, tb.cat) >= 0.99
        # the unaligned draw of the shard
        batch = 3000
        jc, jk = JFeatureSpec(jpipe.features).sample_for_shard(
            5, tb.shard_id, np.asarray(jb.src), np.asarray(jb.dst),
            jpipe._g_ref.bipartite, batch=batch)
        tc, tk = FeatureSpec(pipe.features).sample_for_shard(
            5, tb.shard_id, np.asarray(tb.src), np.asarray(tb.dst),
            pipe.bipartite, batch=batch)
        assert (np.asarray(tk) == np.asarray(jk)).all(1).mean() >= 0.999
        assert _row_match(jc, jk, tc, tk) >= 0.999
    assert pipe.timings.gen_write_s > 0 and pipe.timings.gen_wall_s > 0
    assert pipe.timings.gen_overlap > 0


def test_featured_datasets_do_not_resume_across_packages(carried):
    jpipe, pipe, _, _, root = carried
    with pytest.raises(ValueError, match="features"):
        pipe.generate_streamed(str(root / "jax"), seed=5, scale_nodes=2,
                               shard_edges=3000, backend="reference",
                               resume=True)
    with pytest.raises(ValueError, match="features"):
        jpipe.generate_streamed(str(root / "port"), seed=5, scale_nodes=2,
                                shard_edges=3000, backend="xla",
                                resume=True)


# -- reader ------------------------------------------------------------------

def test_reader_round_trips(tmp_path, spec, serial_feat):
    ds = ShardedGraphDataset(serial_feat)
    assert ds.total_edges == FIT_FEAT["E"] and ds.has_features
    blocks = list(ds)
    src = np.concatenate([b.src for b in blocks])
    cont = np.concatenate([b.cont for b in blocks])
    g = ds.to_graph(device="cpu")
    assert isinstance(g.src, torch.Tensor) and g.src.dtype == torch.int32
    np.testing.assert_array_equal(g.src.numpy(), src)
    assert (g.n_src, g.n_dst) == (2 ** 10, 2 ** 10)
    c, k = ds.features()
    np.testing.assert_array_equal(c, cont)
    seen, sizes = 0, []
    for s, d, bc, bk in ds.batches(5000):
        np.testing.assert_array_equal(s, src[seen: seen + len(s)])
        np.testing.assert_array_equal(bc, cont[seen: seen + len(s)])
        seen += len(s)
        sizes.append(len(s))
    assert seen == ds.total_edges and sizes[:-1] == [5000] * (len(sizes) - 1)
    with pytest.raises(MemoryError):
        ds.to_graph(max_edges=100)


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


# -- the executor against fake stages ----------------------------------------

def _manifest(n_shards, n_edges=16):
    recs = [ShardRecord(i, f"shard-{i:05d}", [], n_edges)
            for i in range(n_shards)]
    return Manifest(fit={}, seed=0, k_pref=0, shard_edges=n_edges,
                    num_workers=1, dtype="int32",
                    total_edges=n_shards * n_edges, n_src=1 << 20,
                    n_dst=1 << 20, bipartite=False, theta=[],
                    theta_digest="", shards=recs)


class FakeSource(ShardSource):
    name = "fake"

    def __init__(self):
        self.generated = []

    def generate(self, rec):
        self.generated.append(rec.shard_id)
        ids = np.full(rec.n_edges, rec.shard_id, np.int32)
        return {"src": ids, "dst": ids.copy()}


class StubFeatures:
    """FeatureSpec-shaped stub: per-shard delays (out-of-order completion)
    or an injected failure; returns tensors, as the port's generators do."""

    def __init__(self, delays=None, fail_on=None):
        self.delays = delays or {}
        self.fail_on = fail_on
        self.feat_s = 0.0
        self.align_s = 0.0
        self._lock = threading.Lock()

    def sample_for_shard(self, seed, shard_id, src, dst, bipartite,
                         batch=None):
        time.sleep(self.delays.get(shard_id, 0.0))
        if shard_id == self.fail_on:
            raise RuntimeError(f"host stage failed on shard {shard_id}")
        with self._lock:
            self.feat_s += 0.001
        return (torch.full((len(src), 1), float(shard_id)),
                torch.zeros((len(src), 1), dtype=torch.int64))


def _journal_ids(out_dir):
    path = os.path.join(out_dir, JOURNAL_NAME)
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line)["shard_id"] for line in f if line.strip()]


def test_commits_stay_in_order_despite_out_of_order_features(tmp_path):
    out = str(tmp_path / "out")
    manifest = _manifest(6)
    writer = ShardWriter(out, manifest)
    stats = ShardExecutor(FakeSource(), writer,
                          features=StubFeatures(delays={0: 0.2}),
                          pipeline_depth=4, host_workers=2).run(
                              manifest.shards)
    assert _journal_ids(out) == list(range(6)) and stats.n_shards == 6
    blk = np.load(os.path.join(out, manifest.shards[3].files["cont"]))
    assert blk.dtype == np.float32 and blk[0, 0] == 3.0
    assert np.load(os.path.join(
        out, manifest.shards[3].files["cat"])).dtype == np.int32


def test_pipeline_depth_bounds_in_flight_shards(tmp_path):
    out = str(tmp_path / "out")
    manifest = _manifest(12)
    writer = ShardWriter(out, manifest)
    lead = []
    orig = writer.write_shard
    src = FakeSource()

    def slow_write(shard_id, arrays):
        time.sleep(0.03)
        lead.append(len(src.generated) - shard_id)
        return orig(shard_id, arrays)

    writer.write_shard = slow_write
    ShardExecutor(src, writer, pipeline_depth=2).run(manifest.shards)
    assert manifest.is_complete() and max(lead) <= 2 * 2 + 2


@pytest.mark.parametrize("stage", ["host", "write"])
def test_stage_failure_leaves_clean_prefix(tmp_path, stage):
    out = str(tmp_path / "out")
    manifest = _manifest(8)
    writer = ShardWriter(out, manifest)
    feats = None
    if stage == "host":
        feats = StubFeatures(fail_on=3)
    else:
        orig = writer.write_shard

        def bad_write(shard_id, arrays):
            if shard_id == 2:
                raise OSError("disk full")
            return orig(shard_id, arrays)

        writer.write_shard = bad_write
    ex = ShardExecutor(FakeSource(), writer, features=feats,
                       pipeline_depth=2, host_workers=2)
    with pytest.raises(RuntimeError, match="shard 3" if stage == "host"
                       else "disk full"):
        ex.run(manifest.shards)
    done = _journal_ids(out)
    assert done == list(range(len(done)))
    assert done == [0, 1] if stage == "write" else len(done) <= 3
    for sid in done:
        assert writer.shard_ok_on_disk(manifest.shards[sid], deep=True)


def test_stats_account_all_stages(tmp_path):
    out = str(tmp_path / "out")
    manifest = _manifest(6)
    feats = StubFeatures()
    stats = ShardExecutor(FakeSource(), ShardWriter(out, manifest),
                          features=feats, pipeline_depth=2,
                          host_workers=2).run(manifest.shards)
    assert isinstance(stats, ExecutorStats) and stats.n_shards == 6
    assert stats.wall_s > 0 and stats.write_s > 0
    assert stats.feat_s == pytest.approx(feats.feat_s)
    assert stats.overlap == pytest.approx(stats.busy_s / stats.wall_s)
    with pytest.raises(ValueError, match="pipeline_depth"):
        ShardExecutor(FakeSource(), None, pipeline_depth=-1)
    with pytest.raises(ValueError, match="host_workers"):
        ShardExecutor(FakeSource(), None, host_workers=0)


def test_async_flush_queue_surfaces_write_errors(tmp_path):
    out = str(tmp_path / "out")
    manifest = _manifest(3, n_edges=4)
    writer = ShardWriter(out, manifest)
    q = writer.async_flush(depth=1)
    ids = np.zeros(4, np.int32)
    q.submit(0, {"src": ids, "dst": ids})
    q.submit(1, {"src": ids, "dst": ids})
    q.close()
    assert _journal_ids(out) == [0, 1]
    q2 = writer.async_flush(depth=1)
    q2.submit(2, {"src": ids[:1], "dst": ids[:1]})   # wrong row count
    with pytest.raises(RuntimeError, match="flush"):
        for _ in range(50):
            q2.submit(2, {"src": ids, "dst": ids})
            time.sleep(0.01)
    with pytest.raises(RuntimeError):
        q2.close()


# -- the command line --------------------------------------------------------

def _cli(*args, check=True):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-m",
                        "repro_torch.scripts.generate_dataset", *args],
                       capture_output=True, text=True, env=env, timeout=300)
    if check:
        assert r.returncode == 0, r.stderr[-3000:]
    return r


def test_cli_stops_resumes_and_matches_the_library(tmp_path):
    """Struct only: the bytes of a run stopped after two shards and
    resumed in another process equal one library run's."""
    fit_json = tmp_path / "fit.json"
    fit_json.write_text(json.dumps(dict(SMALL, noise=0.02)))
    common = ["--fit", str(fit_json), "--scale-nodes", "2", "--shard-edges",
              "16384", "--device", "cpu", "--seed", "2", "--backend",
              "cuda_prng"]
    part = str(tmp_path / "part")
    r = _cli(*common, "--out", part, "--max-shards", "2", "--trace")
    n_shards = len(Manifest.load(part).shards)
    assert f"materialized 2/{n_shards} shards" in r.stderr and n_shards > 2
    refused = _cli(*common, "--out", part, check=False)
    assert refused.returncode != 0 and "--resume" in refused.stderr
    r = _cli(*common, "--out", part, "--resume", "--verify",
             "--pipeline-depth", "3", "--metrics-out",
             str(tmp_path / "m.json"))
    assert "verify: ok" in r.stderr
    full = str(tmp_path / "full")
    DatasetJob(KroneckerFit(**SMALL, noise=0.02).scaled(2), full,
               shard_edges=16384, seed=2, backend="cuda_prng",
               device="cpu").run()
    assert _hashes(part, manifest=False) == _hashes(full, manifest=False)
    assert _manifest_sans_executor(part) == _manifest_sans_executor(full)
    assert os.path.getsize(os.path.join(part, "trace.jsonl")) > 0
    env = json.load(open(tmp_path / "m.json"))
    assert env["env"]["torch"] == torch.__version__
    assert env["metrics"]["timings"]["wall_s"] > 0


def test_cli_writes_the_assets_features(tmp_path):
    """``--asset`` streams the saved fit's GAN features and GBDT
    alignment beside its structure."""
    out = str(tmp_path / "ds")
    r = _cli("--asset", str(ASSET), "--edges", "20000", "--shard-edges",
             "8192", "--device", "cpu", "--out", out, "--verify",
             "--host-workers", "2", "--fused")
    assert "features=yes" in r.stderr and "verify: ok" in r.stderr
    ds = ShardedGraphDataset(out)
    assert ds.total_edges == 20_000 and ds.has_features
    assert ds.manifest.features["aligner_stream"] == "torch-gbdt-v2"
    assert ds.manifest.executor["fused"] is True
    c, k = ds.features()
    assert c.shape == (20_000, 2) and k.shape == (20_000, 3)
    assert np.isfinite(c).all()
