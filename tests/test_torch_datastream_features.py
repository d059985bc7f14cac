"""The port's ``datastream`` with features, on the CPU: serial =
double-buffered = pipelined = fused = resumed byte for byte with a
port-fitted GAN generator and GBDT aligner, a feature-stage failure that
leaves a clean prefix, featured resumes refusing other settings, and the
reader over a featured dataset.  (Split from
``tests/test_torch_datastream.py`` along its ``spec`` fixture.)
"""
import hashlib
import json
import os
import threading

import jax
import numpy as np
import pytest
import torch

from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (DatasetJob, FeatureSpec, Manifest,
                                    ShardedGraphDataset)

THETA = dict(a=0.45, b=0.22, c=0.2, d=0.13)


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
