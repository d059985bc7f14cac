"""The port's ``datastream`` against the JAX package with features
carried across, the executor against fake stages, and the command line,
on the CPU.

Features against the JAX package (a JAX fit carried across): struct
shards byte-identical; per shard, the unaligned draw's category ids equal
and continuous values within 1e-5 on ≥ 99.9% of rows (the GAN's float
sums differ from XLA's in the last ulps, and a Gumbel-max argmax can flip
on a near-tie); aligned rows equal on ≥ 99% (rank matching moves a row to
a neighbour slot on a near-tie) — the tolerances of
``tests/test_torch_pipeline.py``.  (Split from
``tests/test_torch_datastream.py`` along its ``carried`` fixture.)
"""
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

from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (DatasetJob, ExecutorStats, FeatureSpec,
                                    Manifest, ShardedGraphDataset,
                                    ShardExecutor, ShardRecord, ShardSource,
                                    ShardWriter)
from repro_torch.datastream.writer import JOURNAL_NAME

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"
THETA = dict(a=0.45, b=0.22, c=0.2, d=0.13)
#: small enough for the Pallas kernel in interpret mode; E is not a
#: multiple of the shard size, so the last shard is ragged
SMALL = dict(THETA, n=10, m=10, E=14_000)


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


def _manifest_sans_executor(path):
    with open(os.path.join(path, "manifest.json")) as f:
        d = json.load(f)
    d.pop("executor", None)
    return d


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
