"""The port's multi-process generation cluster
(``repro_torch.distributed``) on the CPU: per-worker journals, the strict
merge, worker stripes through the API and the CLI, torn journals, the
launcher, and the coordinator's 2-worker and kill-and-rebalance runs —
each byte-identical to the port's serial ``DatasetJob`` and to the JAX
package's on the 12-shard plan (shard ``.npy`` files exact;
``manifest.json`` equal without placement provenance).  Struct only:
featured bytes on the CPU may differ between processes (torch's CPU float
kernels), so featured cluster equality is held on the card
(``tests/test_torch_cuda.py``, the smoke's phase 17).
"""
import argparse
import dataclasses
import hashlib
import json
import os
import sys

import pytest
import torch

from repro.core.structure import KroneckerFit as JFit
from repro.datastream import DatasetJob as JJob
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (DatasetJob, Manifest,
                                    ShardedGraphDataset,
                                    worker_journal_name,
                                    worker_journal_paths)
from repro_torch.datastream.writer import JOURNAL_NAME, MANIFEST_NAME
from repro_torch.distributed import (ClusterCoordinator, ClusterError,
                                     WorkerProcess, python_argv,
                                     repro_torch_pythonpath)
from repro_torch.scripts import generate_dataset as gen_cli

THETA = dict(a=0.45, b=0.22, c=0.2, d=0.13)
FIT = KroneckerFit(**THETA, n=10, m=10, E=8_000)
SHARD_EDGES = 2_000
SEED = 3
#: the coordinator runs use a bigger plan (12 shards) so each stripe
#: holds several shards — killing a worker after its first commit then
#: reliably leaves an uncommitted suffix to rebalance.  Its 16 chunks
#: (k_pref 2; the auto k_pref gives 256) keep the JAX run's compiles few.
FIT_BIG = KroneckerFit(**THETA, n=11, m=11, E=24_000)


def _k_pref(fit):
    return 2 if fit is FIT_BIG else None


def _job(out, fit=FIT, num_workers=1):
    return DatasetJob(fit, str(out), shard_edges=SHARD_EDGES, seed=SEED,
                      k_pref=_k_pref(fit), num_workers=num_workers,
                      double_buffered=False, pipeline_depth=0, device="cpu")


def _file_hashes(path):
    return {f: hashlib.md5(open(os.path.join(path, f), "rb").read())
            .hexdigest()
            for f in sorted(os.listdir(path)) if f.endswith(".npy")}


def _manifest_sans_placement(path):
    """manifest.json minus placement provenance: worker count, executor
    knobs and per-shard worker assignment don't change a byte of data."""
    with open(os.path.join(path, MANIFEST_NAME)) as f:
        d = json.load(f)
    d.pop("executor", None)
    d.pop("num_workers", None)
    for s in d["shards"]:
        s.pop("worker", None)
    return d


@pytest.fixture(scope="module")
def serial_ref(tmp_path_factory):
    """The port's uninterrupted single-process run of ``FIT``."""
    port = str(tmp_path_factory.mktemp("serial_ref") / "port")
    assert _job(port).run().is_complete()
    return (port,)


@pytest.fixture(scope="module")
def serial_ref_big(tmp_path_factory):
    """The port's and the JAX package's uninterrupted single-process runs
    of ``FIT_BIG``; both equal (the ``xla`` stream on the CPU)."""
    port = str(tmp_path_factory.mktemp("serial_ref_big") / "port")
    jax_out = str(tmp_path_factory.mktemp("serial_ref_big") / "jax")
    assert _job(port, FIT_BIG).run().is_complete()
    JJob(JFit(**dataclasses.asdict(FIT_BIG)), jax_out,
         shard_edges=SHARD_EDGES, seed=SEED, k_pref=_k_pref(FIT_BIG),
         double_buffered=False, pipeline_depth=0).run()
    assert len(Manifest.load(port).shards) == 12
    assert _file_hashes(port) == _file_hashes(jax_out)
    assert _manifest_sans_placement(port) == \
        _manifest_sans_placement(jax_out)
    return port, jax_out


def _same_as_serial(out, refs):
    for ref in refs:
        assert _file_hashes(out) == _file_hashes(ref)
        assert _manifest_sans_placement(out) == _manifest_sans_placement(ref)


# -- journal namespacing -----------------------------------------------------

def test_worker_journal_paths_sort_numerically(tmp_path):
    for k in (10, 0, 2):
        (tmp_path / worker_journal_name(k)).write_text("")
    (tmp_path / "journal.wx.jsonl").write_text("")   # not a worker journal
    (tmp_path / JOURNAL_NAME).write_text("")
    paths = worker_journal_paths(str(tmp_path))
    assert [os.path.basename(p) for p in paths] == \
        ["journal.w0.jsonl", "journal.w2.jsonl", "journal.w10.jsonl"]
    assert worker_journal_paths(str(tmp_path / "missing")) == []


# -- worker-stripe runs + merge ----------------------------------------------

def test_worker_stripes_merge_byte_identical_to_serial(serial_ref, tmp_path):
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    manifest_bytes = open(os.path.join(out, MANIFEST_NAME), "rb").read()
    for k in (0, 1):
        _job(out, num_workers=2).run_worker(k)
        assert os.path.exists(os.path.join(out, worker_journal_name(k)))
    assert open(os.path.join(out, MANIFEST_NAME), "rb").read() == \
        manifest_bytes
    assert not os.path.exists(os.path.join(out, JOURNAL_NAME))
    merged = Manifest.load(out)
    stats = merged.merge_worker_journals(out)
    assert set(stats) == {"journal.w0.jsonl", "journal.w1.jsonl"}
    assert sum(s["shards"] for s in stats.values()) == len(merged.shards)
    assert all(s["shards"] > 0 for s in stats.values())
    assert sum(s["edges"] for s in stats.values()) == FIT.E
    merged.save(out)
    for p in worker_journal_paths(out):
        os.remove(p)
    assert merged.is_complete() and merged.done_edges() == FIT.E
    _same_as_serial(out, serial_ref)
    ds = ShardedGraphDataset(out)
    assert ds.total_edges == FIT.E and not ds.verify(deep=True)


def test_merge_handles_out_of_order_journals(tmp_path):
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    for k in (0, 1):
        _job(out, num_workers=2).run_worker(k)
    for p in worker_journal_paths(out):
        lines = open(p).read().splitlines()
        with open(p, "w") as f:
            f.write("\n".join(reversed(lines)) + "\n")
    merged = Manifest.load(out)
    merged.merge_worker_journals(out)
    assert merged.is_complete() and merged.done_edges() == FIT.E
    # merging twice (a coordinator retry after a crash before cleanup)
    # is idempotent
    merged.save(out)
    again = Manifest.load(out)
    again.merge_worker_journals(out)
    assert again.to_json() == merged.to_json()


def test_merge_rejects_duplicate_shard_across_journals(tmp_path):
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    _job(out, num_workers=2).run_worker(0)
    w0 = os.path.join(out, worker_journal_name(0))
    first = open(w0).read().splitlines()[0]
    with open(os.path.join(out, worker_journal_name(1)), "w") as f:
        f.write(first + "\n")
    with pytest.raises(ValueError, match="stripes overlapped"):
        Manifest.load(out).merge_worker_journals(out)


# -- torn journal tails ------------------------------------------------------

def test_replay_skips_torn_final_journal_line(tmp_path):
    out = str(tmp_path / "ds")
    _job(out).run(max_shards=2)
    journal = os.path.join(out, JOURNAL_NAME)
    done = [s for s in Manifest.load(out).shards if s.status == "done"]
    assert len(done) == 2
    with open(journal, "a") as f:
        f.write(json.dumps(done[0].to_json()) + "\n")
        f.write(json.dumps(done[1].to_json())[:25])
    replayed = Manifest.load(out)          # must not raise
    assert [s.shard_id for s in replayed.shards if s.status == "done"] \
        == [s.shard_id for s in done]
    assert _job(out).run(resume=True).is_complete()


def test_merge_skips_torn_worker_journal_tail(tmp_path):
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    _job(out, num_workers=2).run_worker(0)
    w0 = os.path.join(out, worker_journal_name(0))
    lines = open(w0).read().splitlines()
    with open(w0, "a") as f:
        f.write(lines[-1][:30])            # torn re-append, no newline
        f.write("\nnot json either")       # and a corrupt complete line
    stats = Manifest.load(out).merge_worker_journals(out)
    assert stats["journal.w0.jsonl"]["shards"] == len(lines)


# -- run_worker validation ---------------------------------------------------

def test_run_worker_requires_existing_plan(tmp_path):
    with pytest.raises(FileNotFoundError, match="plans first"):
        _job(str(tmp_path / "nope"), num_workers=2).run_worker(0)


def test_run_worker_validates_stripe_count(tmp_path):
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    with pytest.raises(ValueError, match="num_workers=2"):
        _job(out, num_workers=3).run_worker(0)
    with pytest.raises(ValueError, match="stripes"):
        _job(out, num_workers=2).run_worker(2)


# -- the CLI's stripe mode ---------------------------------------------------

def _fit_json(tmp_path, fit):
    path = str(tmp_path / "fit.json")
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(fit), f)
    return path


def test_cli_worker_stripe_mode(serial_ref, tmp_path):
    out = str(tmp_path / "ds")
    base = ["--fit", _fit_json(tmp_path, FIT), "--shard-edges",
            str(SHARD_EDGES), "--out", out, "--seed", str(SEED), "--serial",
            "--device", "cpu"]
    # the reference's argument checks
    for bad in (["--worker-id", "0"],
                ["--num-workers", "0"],
                ["--num-workers", "2", "--workers", "2"],
                ["--num-workers", "2", "--worker-id", "2"]):
        with pytest.raises(SystemExit):
            gen_cli.main(base + bad)
    with pytest.raises(SystemExit):        # no plan to run against
        gen_cli.main(base + ["--num-workers", "2", "--worker-id", "0"])
    _job(out, num_workers=2).plan()
    with pytest.raises(SystemExit):        # the plan's stripe count
        gen_cli.main(base + ["--num-workers", "3", "--worker-id", "0"])
    for k in (0, 1):
        rc = gen_cli.main(base + ["--num-workers", "2",
                                  "--worker-id", str(k), "--trace",
                                  "--metrics-out",
                                  str(tmp_path / "metrics.json")])
        assert rc == 0
        assert os.path.exists(os.path.join(out, f"trace.w{k}.jsonl"))
        env = json.load(open(tmp_path / f"metrics.w{k}.json"))
        assert set(env["metrics"]["launches"]) == {
            "rmat_sample_uniforms", "rmat_sample_bits", "rmat_sample_prng"}
    merged = Manifest.load(out)
    merged.merge_worker_journals(out)
    assert merged.is_complete()
    assert _file_hashes(out) == _file_hashes(serial_ref[0])


def test_cli_in_process_worker_queues(serial_ref, tmp_path):
    """``--workers 2 --worker k`` (in-process striping, one queue a call)
    covers the plan with the serial bytes."""
    out = str(tmp_path / "ds")
    base = ["--fit", _fit_json(tmp_path, FIT), "--shard-edges",
            str(SHARD_EDGES), "--out", out, "--seed", str(SEED), "--serial",
            "--device", "cpu", "--workers", "2"]
    assert gen_cli.main(base + ["--worker", "0"]) == 0
    assert not Manifest.load(out).is_complete()
    assert gen_cli.main(base + ["--worker", "1", "--resume"]) == 0
    assert Manifest.load(out).is_complete()
    assert _file_hashes(out) == _file_hashes(serial_ref[0])


def test_worker_flags_carry_the_ports_flags():
    ns = argparse.Namespace(
        asset="fit.npz", fit="demo", out="ds", scale_nodes=16,
        shard_edges="1<<21", seed=2, mode="chunks", device="cuda",
        pipeline_depth=2, host_workers=2, edges=None, k_pref=None,
        noise=0.0, backend=None, id_dtype=None, max_shards=None,
        fused=True, serial=False, trace="auto", metrics_out="m.json",
        torch_profile="prof")
    flags = gen_cli.worker_flags(ns, 1, 2)
    pairs = dict(zip(flags[::2], flags[1::2]))
    assert pairs["--asset"] == "fit.npz" and "--fit" not in flags
    assert (pairs["--scale-nodes"], pairs["--device"],
            pairs["--torch-profile"]) == ("16", "cuda", "prof")
    assert (pairs["--num-workers"], pairs["--worker-id"]) == ("2", "1")
    assert "--fused" in flags and "--trace" in flags
    ns.asset = None
    assert gen_cli.worker_flags(ns, 0, 1)[:2] == ["--fit", "demo"]
    assert gen_cli.worker_path("out/trace.jsonl", 3) == "out/trace.w3.jsonl"


def test_coordinator_plans_an_asset_on_the_cpu():
    """The coordinator's copy of a featured fit stays on the CPU (it makes
    no CUDA context) and records the workers' device in the plan."""
    from pathlib import Path
    asset = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
             / "assets" / "tabformer_like_fit.npz")
    ns = argparse.Namespace(asset=str(asset), device="cuda", edges=None,
                            scale_nodes=4, noise=0.0)
    fit, spec = gen_cli.plan_asset(ns)
    assert fit.E == 40_000 * 16
    assert spec.work_device == torch.device("cuda")
    weights = list(spec.generator.generator.parameters())
    assert weights and all(w.device.type == "cpu" for w in weights)
    assert spec.describe() == {"n_cont": 2, "cat_cards": list(
        spec.generator.schema.cat_cards)}
    assert spec.generator.stream_marker == "torch-gan-v1"
    assert not torch.cuda.is_initialized()


# -- the launcher ------------------------------------------------------------

def test_worker_process_tails_only_complete_lines(tmp_path):
    journal = str(tmp_path / "j.jsonl")
    proc = WorkerProcess(
        0, python_argv("-c", "import time; time.sleep(5)"),
        journal_path=journal, log_dir=str(tmp_path))
    try:
        assert proc.alive()
        assert proc.poll_journal() == []          # no journal yet
        with open(journal, "w") as f:
            f.write('{"status": "done", "n_edges": 7}\n{"status": "do')
            f.flush()
        assert proc.poll_journal() == [{"status": "done", "n_edges": 7}]
        assert proc.poll_journal() == []          # partial line deferred
        with open(journal, "a") as f:
            f.write('ne", "n_edges": 5}\n')
        assert proc.poll_journal() == [{"status": "done", "n_edges": 5}]
    finally:
        proc.kill()
    assert not proc.alive() and proc.returncode is not None
    assert os.path.exists(proc.log_path)


def test_pythonpath_resolves_the_port():
    root = repro_torch_pythonpath()
    assert os.path.isdir(os.path.join(root, "repro_torch", "distributed"))
    assert python_argv("-m", "x") == [sys.executable, "-m", "x"]


# -- the coordinator ---------------------------------------------------------

def _worker_argv(fit_json, out, fit=FIT_BIG, device="cpu"):
    k_pref = [] if _k_pref(fit) is None else ["--k-pref", str(_k_pref(fit))]

    def build(worker_id, num_workers):
        return python_argv(
            "-m", "repro_torch.scripts.generate_dataset", "--fit", fit_json,
            "--shard-edges", str(SHARD_EDGES), "--out", out, "--seed",
            str(SEED), "--serial", "--device", device, *k_pref,
            "--num-workers", str(num_workers), "--worker-id", str(worker_id))
    return build


def test_coordinator_requires_plan(tmp_path):
    with pytest.raises(ClusterError, match="no manifest"):
        ClusterCoordinator(str(tmp_path), lambda w, W: ["true"],
                           num_workers=2).run()


def test_coordinator_two_workers_byte_identical(serial_ref_big, tmp_path):
    out = str(tmp_path / "ds")
    _job(out, FIT_BIG, num_workers=2).plan()
    coord = ClusterCoordinator(
        out, _worker_argv(_fit_json(tmp_path, FIT_BIG), out),
        num_workers=2)
    manifest = coord.run()
    assert manifest.is_complete() and manifest.done_edges() == FIT_BIG.E
    assert len(coord.report["rounds"]) == 1
    assert coord.report["rounds"][0]["deaths"] == 0
    assert all(w["shards"] > 0
               for w in coord.report["rounds"][0]["workers"].values())
    assert worker_journal_paths(out) == []       # merged and cleaned up
    _same_as_serial(out, serial_ref_big)
    assert not ShardedGraphDataset(out).verify(deep=True)


def test_coordinator_kill_rebalance_byte_identical(serial_ref_big,
                                                   tmp_path):
    out = str(tmp_path / "ds")
    _job(out, FIT_BIG, num_workers=2).plan()
    coord = ClusterCoordinator(
        out, _worker_argv(_fit_json(tmp_path, FIT_BIG), out),
        num_workers=2, poll_s=0.02, kill_after={1: 1})
    manifest = coord.run()
    assert manifest.is_complete() and manifest.done_edges() == FIT_BIG.E
    rounds = coord.report["rounds"]
    assert rounds[0]["deaths"] == 1
    assert rounds[0]["workers"]["1"]["killed"]
    # the dead worker's suffix re-striped across the survivor count
    assert len(rounds) >= 2 and rounds[1]["num_workers"] == 1
    assert Manifest.load(out).num_workers == 1
    _same_as_serial(out, serial_ref_big)
    assert not ShardedGraphDataset(out).verify(deep=True)


_HANG = python_argv("-c", "import time; time.sleep(120)")


def test_stalled_worker_is_killed_and_its_stripe_rebalanced(
        serial_ref_big, tmp_path):
    """A worker that lives but commits nothing for ``heartbeat_timeout_s``
    is SIGKILLed as stalled; its stripe goes to the survivor next round,
    with the serial run's bytes."""
    out = str(tmp_path / "ds")
    _job(out, FIT_BIG, num_workers=2).plan()
    real = _worker_argv(_fit_json(tmp_path, FIT_BIG), out)
    coord = ClusterCoordinator(
        out, lambda w, W: _HANG if (w, W) == (1, 2) else real(w, W),
        num_workers=2, poll_s=0.05, heartbeat_timeout_s=15.0)
    manifest = coord.run()
    assert manifest.is_complete()
    rounds = coord.report["rounds"]
    hung = rounds[0]["workers"]["1"]
    assert hung["stalled"] and hung["killed"] and hung["shards"] == 0
    assert rounds[0]["deaths"] == 1 and rounds[1]["num_workers"] == 1
    _same_as_serial(out, serial_ref_big)


def test_a_round_of_stalled_workers_raises(tmp_path):
    """Every worker hangs: each is killed as stalled, and the round, with
    nothing committed, raises instead of waiting forever."""
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    coord = ClusterCoordinator(out, lambda w, W: _HANG, num_workers=2,
                               poll_s=0.05, heartbeat_timeout_s=0.5)
    with pytest.raises(ClusterError, match="stuck"):
        coord.run()
    workers = coord.report["rounds"][0]["workers"].values()
    assert all(w["stalled"] and w["killed"] for w in workers)


def test_workers_without_a_card_fail_the_cluster(tmp_path):
    """``--device cuda`` with no card: each worker exits non-zero and the
    round, with deaths and nothing committed, raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    out = str(tmp_path / "ds")
    _job(out, num_workers=2).plan()
    coord = ClusterCoordinator(
        out, _worker_argv(_fit_json(tmp_path, FIT), out, FIT,
                          device="cuda"),
        num_workers=2, poll_s=0.02)
    with pytest.raises(ClusterError, match="2 worker death"):
        coord.run()
    assert len(coord.report["rounds"]) == 1
    log = open(os.path.join(out, "worker.w0.log")).read()
    assert "no CUDA card" in log
