"""The port's benchmark runner, its shared helpers, the BENCH envelope's
card fields, and ``obs.export`` / ``scripts.report_run`` against the JAX
package's, on the CPU."""
import importlib.util
import json
import subprocess
import threading
from pathlib import Path

import pytest
import torch

from repro.obs.export import to_chrome_trace as jax_to_chrome_trace
from repro_torch.benchmarks import common, run as bench_run
from repro_torch.obs import JsonlSink, MemorySink, Tracer, load_events
from repro_torch.obs import metrics
from repro_torch.obs.export import export_chrome_trace, to_chrome_trace
from repro_torch.scripts import report_run

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


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def jax_runner(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    return _load(ROOT / "benchmarks" / "run.py", "jax_benchmarks_run")


def test_tables_are_the_jax_runners_but_two(jax_runner):
    """Every JAX table but ``cluster_scaling`` (ROADMAP A5) and
    ``roofline`` (A7), in the JAX runner's order, each a module with
    ``run(fast, device)``."""
    assert bench_run.TABLES == [t for t in jax_runner.TABLES
                                if t not in ("cluster_scaling", "roofline")]
    assert len(bench_run.TABLES) == 13
    for name in bench_run.TABLES:
        mod = __import__(f"repro_torch.benchmarks.{name}",
                         fromlist=["run"])
        params = mod.run.__code__.co_varnames[:mod.run.__code__.co_argcount]
        assert {"fast", "device"} <= set(params), name
        assert mod.run.__defaults__[params.index("device")
                                    - len(params)] == "cuda", name


def test_runner_refuses_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as e:
        bench_run.main([])
    assert "no CUDA card" in str(e.value.code)
    assert capsys.readouterr().out == ""       # no table ran
    with pytest.raises(RuntimeError, match="no CUDA card"):
        common.device_of("cuda")


def test_runner_runs_the_rest_and_fails_on_a_failed_table(monkeypatch,
                                                          capsys):
    ran = []

    def run_table(name, fast, device):
        ran.append((name, fast, device))
        if name == "table8_er_timings":
            raise RuntimeError("kernel did not build")
        return []
    monkeypatch.setattr(bench_run, "run_table", run_table)
    with pytest.raises(SystemExit) as e:
        bench_run.main(["--device", "cpu", "--full"])
    assert e.value.code == "benchmarks failed: ['table8_er_timings']"
    assert ran == [(t, False, "cpu") for t in bench_run.TABLES]
    assert "table8_er_timings FAILED: RuntimeError" in capsys.readouterr().err


def test_runner_one_table_on_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)
    bench_run.main(["--device", "cpu", "--only", "gnn_throughput"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [line.split(",")[0] for line in out[1:]] == [
        f"gnn/{k}/{v}" for k in ("gcn", "gat")
        for v in ("original", "ours", "random")]
    assert (tmp_path / "results" / "bench_torch"
            / "gnn_throughput.json").exists()
    assert not (tmp_path / "results" / "bench").exists()


def test_timeit_synchronizes_around_every_call(monkeypatch):
    order = []
    monkeypatch.setattr(common, "sync", lambda dev: order.append("sync"))
    us = common.timeit(lambda: order.append("call"), repeats=3, warmup=1,
                       device="cuda")
    assert us >= 0
    assert order == ["call"] + ["sync", "call", "sync"] * 3


def test_envelope_names_no_card_on_the_cpu(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    env = common.emit_bench("probe", {"x": 1})
    assert env["env"]["device"] == "cpu"
    if not torch.cuda.is_available():
        assert env["env"]["card"] is None
        assert env["env"]["power_limit"] is None
    on_disk = json.loads((tmp_path / "results" / "bench_torch"
                          / "BENCH_probe.json").read_text())
    assert on_disk["env"]["power_limit"] == env["env"]["power_limit"]
    assert on_disk["metrics"] == {"x": 1}


def test_gpu_line_parses_nvidia_smi(monkeypatch):
    def fake(args, **kw):
        if args[0] != "nvidia-smi":             # git: no sha
            return subprocess.CompletedProcess(args, 1, b"", b"")
        assert args == ["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"]
        return subprocess.CompletedProcess(
            args, 0, "NVIDIA H100 80GB HBM3, 700.00 W\n", "")
    monkeypatch.setattr(metrics.subprocess, "run", fake)
    assert metrics.gpu_line() == "NVIDIA H100 80GB HBM3, 700.00 W"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda i=0: "NVIDIA H100 80GB HBM3")
    env = metrics.run_env()
    assert env["card"] == "NVIDIA H100 80GB HBM3"
    assert env["power_limit"] == "700.00 W"

    def missing(args, **kw):
        raise FileNotFoundError(args[0])
    monkeypatch.setattr(metrics.subprocess, "run", missing)
    assert metrics.gpu_line() is None
    assert metrics.run_env()["power_limit"] is None


def _traced_events():
    """A run's events from the port's tracer: spans on two threads,
    nested spans, an instant and a stall."""
    sink = MemorySink()
    tr = Tracer([sink])

    def feature_lane():
        for name in ("feat", "align"):
            with tr.span(name, shard=0):
                pass
    with tr.span("run"):
        with tr.span("struct", shard=0):
            with tr.span("struct.dispatch"):
                pass
        worker = threading.Thread(target=feature_lane, name="shard-feat-0")
        worker.start()
        worker.join(timeout=30)
        assert not worker.is_alive()
        with tr.span("stall.host"):
            pass
        with tr.span("write", shard=0):
            pass
    return [{"ev": "meta", "pid": 7}] + sink.events + [
        {"ev": "instant", "name": "resume", "ts": 0.5, "tid": "MainThread",
         "args": {"shards": 2}}]


def test_chrome_trace_equals_reference():
    events = _traced_events()
    got = to_chrome_trace(events, process_name="p")
    assert got == jax_to_chrome_trace(events, process_name="p")
    lanes = {e["tid"] for e in got["traceEvents"] if e["ph"] == "X"}
    assert len(lanes) >= 2


def test_report_equals_reference(tmp_path):
    jrep = _load(ROOT / "scripts" / "report_run.py", "jax_report_run")
    events = _traced_events()
    rep = report_run.summarize(events)
    assert rep == jrep.summarize(events)
    assert report_run.format_report(rep) == jrep.format_report(rep)
    reps = [rep, report_run.summarize(events[:5])]
    merged = report_run.merge_reports(reps)
    assert merged == jrep.merge_reports(reps)
    assert report_run.format_cluster_report(["a", "b"], reps, merged) == \
        jrep.format_cluster_report(["a", "b"], reps, merged)


def test_report_cli_writes_the_perfetto_trace(tmp_path, capsys):
    path = tmp_path / "trace.jsonl"
    sink = JsonlSink(str(path))
    for ev in _traced_events():
        sink.emit(ev)
    sink.close()
    out = tmp_path / "perfetto" / "trace.json"
    assert report_run.main([str(path), "--perfetto", str(out)]) == 0
    assert "spans over" in capsys.readouterr().out
    trace = json.loads(out.read_text())
    assert trace == {"traceEvents": to_chrome_trace(
        [{"ev": "meta", "pid": 1}] + load_events(str(path)),
        process_name="trace.jsonl")["traceEvents"], "displayTimeUnit": "ms"}
    n = export_chrome_trace(str(path), str(tmp_path / "t2.json"))
    assert n == len(json.loads((tmp_path / "t2.json").read_text())
                    ["traceEvents"])
    with pytest.raises(SystemExit, match="no events"):
        empty = tmp_path / "empty.jsonl"
        empty.write_text("")
        report_run.main([str(empty)])
