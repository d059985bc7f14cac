"""The port's dataset tables (``repro_torch.benchmarks``: datastream,
fit and executor throughput) against the JAX package's ``benchmarks/``
modules, on the CPU, each in a temporary working directory.

Their results are dicts: the port's must carry the JAX module's keys and
sizes.  ``fit_throughput`` runs whole in both packages, and its row count
and the streamed-vs-in-memory θ difference must agree.  Of the JAX
datastream and executor modules only the loop around the timed jobs runs
(a job stand-in makes the output directory and reports the JAX job's
timing keys): their results hold only times.
"""
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.datastream import DatasetJob as JDatasetJob
from repro_torch.benchmarks import (datastream_throughput, executor_overlap,
                                    fit_throughput)

ROOT = Path(__file__).resolve().parents[1]

#: torch's intra-op threads in these tests
TORCH_THREADS = 2


@pytest.fixture(autouse=True)
def few_torch_threads():
    """``TORCH_THREADS`` intra-op threads for the port: the suite runs in
    several worker processes at once, and a full torch thread pool in
    each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_table(tmp_path, monkeypatch):
    """Load ``benchmarks/<name>.py`` by path, in a temporary working
    directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(ROOT))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"jax_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


def _envelope(tmp_path, suite):
    env = json.loads((tmp_path / "results" / "bench_torch"
                      / f"BENCH_{suite}.json").read_text())
    assert env["suite"] == suite and env["env"]["device"] == "cpu"
    assert env["env"]["card"] is None and env["env"]["power_limit"] is None
    return env["metrics"]


def test_datastream_keys_and_sizes(jax_table, tmp_path, monkeypatch):
    jmod = jax_table("datastream_throughput")

    def job(fit, out, dbl, shard_edges):
        os.makedirs(out)
        return 1.0
    monkeypatch.setattr(jmod, "_materialize", job)
    want = jmod.run(fast=True)
    got = datastream_throughput.run(fast=True, device="cpu")
    assert got.keys() == want.keys()
    assert (got["edges"], got["shard_edges"]) == (want["edges"],
                                                  want["shard_edges"])
    for label in ("double_buffered", "serial"):
        assert got[label].keys() == want[label].keys()
        assert got[label]["edges_per_sec"] > 0
    assert _envelope(tmp_path, "datastream")["edges"] == got["edges"]


def test_fit_throughput_equals_reference(jax_table, tmp_path):
    want = jax_table("fit_throughput").run(fast=True)
    got = fit_throughput.run(fast=True, device="cpu")
    assert got.keys() == want.keys()
    assert (got["rows"], got["shard_edges"]) == (want["rows"],
                                                 want["shard_edges"])
    assert got["device"] == "cpu"
    assert abs(got["theta_delta"] - want["theta_delta"]) <= 1e-9
    for k in ("streamed_fit", "inmemory_fit", "bitpair_mle",
              "degree_sketch", "reservoir"):
        assert got[k].keys() == want[k].keys() and got[k]["rows_per_s"] > 0
    assert _envelope(tmp_path, "fit")["theta_delta"] == got["theta_delta"]


def _jax_job_timings(tmp_path) -> dict:
    """A JAX ``DatasetJob``'s stage timings (its keys, all 0)."""
    from repro.core.structure import KroneckerFit
    fit = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=8, m=8, E=64)
    return dict(JDatasetJob(fit, str(tmp_path / "unused")).timings)


def test_executor_overlap_keys(jax_table, tmp_path, monkeypatch):
    jmod = jax_table("executor_overlap")
    timings = _jax_job_timings(tmp_path)

    def materialize(fit, out, depth, workers, shard_edges, features):
        os.makedirs(out)
        return 1.0, dict(timings)

    def fused_vs_staged(shard_edges, n_shards, k_pref, root):
        return {"edges": shard_edges * n_shards}
    monkeypatch.setattr(jmod, "_materialize", materialize)
    monkeypatch.setattr(jmod, "_fused_vs_staged_bench", fused_vs_staged)
    want = jmod.run(smoke=True)
    got = executor_overlap.run(smoke=True, device="cpu")
    assert got.keys() == want.keys()
    for k in ("edges", "shard_edges", "smoke", "configs"):
        assert got[k] == want[k]
    for label in ("serial_feat", "pipelined_feat", "serial_nofeat",
                  "pipelined_nofeat"):
        assert got[label].keys() == want[label].keys()
        assert got[label]["rows_per_sec"] > 0
    fvs = got["fused_vs_staged"]
    assert fvs["edges"] == want["fused_vs_staged"]["edges"]
    assert fvs.keys() == {"edges", "shard_edges", "k_pref", "staged",
                          "fused", "speedup_fused"}
    for label in ("staged", "fused"):
        assert fvs[label].keys() == {"seconds", "rows_per_sec"} | \
            timings.keys()
    assert got["write_path"].keys() == want["write_path"].keys()
    assert got["write_path"]["rows"] == want["write_path"]["rows"]
    assert _envelope(tmp_path, "executor")["edges"] == got["edges"]


def test_legacy_write_path_is_np_save_and_crc(tmp_path):
    """The write-path comparison's legacy side writes ``np.save``'s bytes
    and gives the crc of the fused pass."""
    from repro_torch.datastream.writer import _atomic_save_npy_crc
    arr = np.arange(1000, dtype=np.int32)
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    assert executor_overlap._legacy_save_crc(str(a), arr) == \
        _atomic_save_npy_crc(str(b), arr)
    assert a.read_bytes() == b.read_bytes()
    np.testing.assert_array_equal(np.load(a), arr)
