"""Lockset race detection over the port's pipelined datastream on the
CPU, against the JAX package's stress run.

Both packages' ``run_stress`` (24 000 edges, shards of 4096,
``pipeline_depth=2``, 2 host workers, the KDE + random-aligner spec) must
report zero candidate races, and their datasets — every ``.npy`` file and
the manifest — must be byte-equal: the same numpy draws, the same
threefry words (the port's ``reference`` sampler reproduces the JAX
``xla`` stream) and IEEE float64 arithmetic on the same values.  The
re-striping resume (worker 0 of 2, then resume with 3 workers) under
detection must give the uninterrupted run's bytes."""
import hashlib
import os

import jax
import pytest

from repro.analysis.races import run_stress as jrun_stress
from repro_torch.analysis.races import run_stress
from repro_torch.datastream import Manifest, ShardedGraphDataset

EDGES = 24_000
SHARD = 4096


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _file_hashes(path, manifest: bool = False):
    return {f: hashlib.md5(
        open(os.path.join(path, f), "rb").read()).hexdigest()
        for f in sorted(os.listdir(path))
        if f.endswith(".npy") or (manifest and f == "manifest.json")}


def test_stress_runs_race_free_and_byte_equal_to_the_reference(tmp_path):
    _require_partitionable()
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    jmon = jrun_stress(jout, edges=EDGES, shard_edges=SHARD,
                       pipeline_depth=2, host_workers=2, seed=0)
    mon = run_stress(out, edges=EDGES, shard_edges=SHARD, pipeline_depth=2,
                     host_workers=2, seed=0, device="cpu")
    assert jmon.races() == []
    assert mon.races() == [], "\n".join(r.render() for r in mon.races())
    # the watched surface really was exercised
    assert mon.n_accesses > 0
    for var in ("FeatureSpec.feat_s", "FeatureSpec.align_s",
                "AsyncFlushQueue.busy_s", "Tracer._totals",
                "Tracer._counts", "ShardWriter._since_checkpoint"):
        assert mon.state_of(var) != "unwatched", var
    # the struct stage's device θ never leaves the struct thread
    assert mon.state_of("ChunkShardSource._suffix_dev") == "exclusive"
    assert Manifest.load(out).is_complete()
    assert ShardedGraphDataset(out).total_edges == EDGES
    assert len(Manifest.load(out).shards) >= 5
    assert _file_hashes(out, manifest=True) == \
        _file_hashes(jout, manifest=True)


def test_restriping_resume_under_detection_is_byte_identical(tmp_path):
    """Worker 0's stripe of a ``num_workers=2`` plan, then the same
    directory resumed with ``num_workers=3`` (re-striped queues), both
    pipelined and instrumented: no candidate races, and the final bytes
    match an uninterrupted single-worker run."""
    ref, out = str(tmp_path / "ref"), str(tmp_path / "ds")
    run_stress(ref, edges=EDGES, shard_edges=SHARD, seed=0, device="cpu")
    assert Manifest.load(ref).is_complete()

    mon1 = run_stress(out, edges=EDGES, shard_edges=SHARD, seed=0,
                      num_workers=2, worker=0, device="cpu")
    assert mon1.races() == []
    m = Manifest.load(out)
    assert m.done_ids() and not m.is_complete()

    mon2 = run_stress(out, edges=EDGES, shard_edges=SHARD, seed=0,
                      num_workers=3, resume=True, device="cpu")
    assert mon2.races() == [], \
        "\n".join(r.render() for r in mon2.races())
    assert Manifest.load(out).is_complete()
    assert _file_hashes(out) == _file_hashes(ref)
