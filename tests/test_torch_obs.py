"""The port's observability layer (``repro_torch.obs``): thread-aware
span nesting, the disabled mode's cost bound, JSONL crash-safety (a torn
tail survives a resume append), metric semantics, the versioned envelope
(torch, CUDA and card instead of jax), the ``torch.profiler`` ranges, and
executor spans that reconcile with ``ExecutorStats``.  The tracer, sinks
and metrics are the JAX package's; the JSONL logs of both packages parse
alike."""
import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.obs import (SCHEMA_VERSION, JsonlSink, MemorySink,
                             MetricsRegistry, Tracer, bench_envelope,
                             load_events, profile)
from repro_torch.obs.trace import NULL_TRACER


def test_span_nesting_single_thread():
    sink = MemorySink()
    tr = Tracer([sink])
    with tr.span("outer", shard=3) as outer:
        with tr.span("inner") as inner:
            time.sleep(0.001)
    assert inner.parent_id == outer.span_id and outer.parent_id is None
    assert inner.dur > 0 and outer.dur >= inner.dur
    assert tr.total("outer") == pytest.approx(outer.dur)
    assert tr.count("inner") == 1
    evs = {e["name"]: e for e in sink.spans()}
    assert evs["inner"]["parent"] == evs["outer"]["id"]
    assert evs["outer"]["args"] == {"shard": 3}
    assert evs["inner"]["ts"] >= evs["outer"]["ts"]


def test_span_nesting_is_per_thread():
    sink = MemorySink()
    tr = Tracer([sink])

    def work(k):
        with tr.span("outer", w=k):
            with tr.span("inner", w=k):
                time.sleep(0.002)

    with tr.span("run"):
        threads = [threading.Thread(target=work, args=(k,),
                                    name=f"obs-worker-{k}")
                   for k in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    by_id = {e["id"]: e for e in sink.spans()}
    outers, inners = sink.spans("outer"), sink.spans("inner")
    assert len(outers) == len(inners) == 3
    assert {e["tid"] for e in outers} == {f"obs-worker-{k}"
                                          for k in range(3)}
    for inner in inners:
        parent = by_id[inner["parent"]]
        assert parent["name"] == "outer" and parent["tid"] == inner["tid"]
    assert all("parent" not in o for o in outers)
    assert tr.total("inner") <= tr.total("outer")


def test_totals_snapshot_diff_and_instant_events():
    sink = MemorySink()
    tr = Tracer([sink])
    with tr.span("a"):
        pass
    before = tr.totals()
    with tr.span("a"):
        time.sleep(0.001)
    assert tr.total("a") - before["a"] >= 0.001 and tr.count("a") == 2
    tr.event("checkpoint", shard=1)
    inst = [e for e in sink.events if e["ev"] == "instant"]
    assert inst[0]["name"] == "checkpoint" and inst[0]["args"] == {
        "shard": 1}
    assert sink.events[0]["ev"] == "meta"


def test_disabled_mode_overhead_bound():
    n = 50_000
    t0 = time.perf_counter()
    for i in range(n):
        with NULL_TRACER.span("x", shard=i):
            pass
    per_span = (time.perf_counter() - t0) / n
    assert per_span < 20e-6, f"null span cost {per_span * 1e6:.2f}us"
    assert NULL_TRACER.total("x") == 0.0 and NULL_TRACER.count("x") == 0
    assert NULL_TRACER.span("x").dur == 0.0 and NULL_TRACER.totals() == {}
    with pytest.raises(ValueError, match="cannot emit"):
        NULL_TRACER.add_sink(MemorySink())


def test_jsonl_torn_tail_survives_resume_append(tmp_path):
    path = str(tmp_path / "trace.jsonl")
    tr = Tracer([JsonlSink(path, flush_every=1)])
    for k in range(4):
        with tr.span("leg1", k=k):
            pass
    tr.close()
    with open(path, "ab") as f:               # crash mid-append
        f.write(b'{"ev":"span","name":"torn","ts":1.0,"dur"')
    tr2 = Tracer([JsonlSink(path, flush_every=1)])
    for k in range(3):
        with tr2.span("leg2", k=k):
            pass
    tr2.close()
    evs = load_events(path)
    names = [e["name"] for e in evs if e.get("ev") == "span"]
    assert names.count("leg1") == 4 and names.count("leg2") == 3
    assert "torn" not in names
    assert sum(e.get("ev") == "meta" for e in evs) == 1


def test_jsonl_tolerates_corrupt_lines_and_reads_the_reference(tmp_path):
    from repro.obs.sinks import load_events as jload
    path = str(tmp_path / "log.jsonl")
    good = {"ev": "span", "name": "ok", "ts": 0.0, "dur": 1.0,
            "tid": "t", "id": 1}
    with open(path, "wb") as f:
        f.write(json.dumps(good).encode() + b"\n")
        f.write(b"\n")
        f.write(b"not json at all\n")
        f.write(b"[1, 2, 3]\n")
        f.write(json.dumps(good).encode() + b"\n")
    evs = load_events(path)
    assert len(evs) == 2 and all(e["name"] == "ok" for e in evs)
    assert evs == jload(path)


def test_jsonl_close_idempotent_and_emit_after_close(tmp_path):
    path = str(tmp_path / "log.jsonl")
    sink = JsonlSink(path, flush_every=1000)
    sink.emit({"ev": "span", "name": "a"})
    sink.close()
    sink.close()
    sink.emit({"ev": "span", "name": "late"})
    assert [e["name"] for e in load_events(path)] == ["a"]


def test_metrics_registry_semantics():
    reg = MetricsRegistry()
    c = reg.counter("rows", "rows")
    c.inc(5)
    c.inc(2.5)
    assert reg.counter("rows").value == 7.5
    g = reg.gauge("depth")
    g.set(3)
    g.set(1)
    assert g.value == 1 and g.max == 3
    with pytest.raises(TypeError, match="already registered"):
        reg.gauge("rows")
    snap = {m["name"]: m for m in reg.snapshot()}
    assert snap["rows"]["kind"] == "counter" and snap["depth"]["max"] == 3
    assert reg.names() == ["depth", "rows"]


def test_histogram_percentiles_bounded_memory():
    h = MetricsRegistry().histogram("lat", "s")
    h._cap = 128
    for v in range(10_000):
        h.observe(float(v))
    assert h.count == 10_000 and len(h._samples) == 128
    snap = h.snapshot()
    assert snap["min"] == 0.0 and snap["max"] == 9999.0
    assert snap["mean"] == pytest.approx(4999.5)
    assert abs(snap["p50"] - 5000) < 2000
    assert snap["p99"] >= snap["p95"] > snap["p50"] >= snap["min"]


def test_envelope_records_torch_and_the_card(tmp_path):
    from repro_torch.obs import write_bench
    env = bench_envelope("unit", {"x": 1}, extra={"note": "t"})
    assert env["schema_version"] == SCHEMA_VERSION
    assert env["suite"] == "unit" and env["metrics"] == {"x": 1}
    assert env["note"] == "t"
    e = env["env"]
    for key in ("git_sha", "host", "python", "cpu_count", "torch", "cuda",
                "device", "n_devices", "card"):
        assert key in e
    assert "jax" not in e and e["torch"] == torch.__version__
    assert e["device"] == ("cuda" if torch.cuda.is_available() else "cpu")
    path = str(tmp_path / "sub" / "m.json")
    write_bench("unit", {"y": 2}, path)
    assert json.load(open(path))["metrics"] == {"y": 2}


def test_profile_annotations(tmp_path):
    assert not profile.profiling()
    with profile.annotation("idle"):
        pass
    log_dir = str(tmp_path / "prof")
    with profile.trace(log_dir) as started:
        assert started and profile.profiling()
        with profile.annotation("struct.dispatch"):
            torch.ones(64).sum()
    assert not profile.profiling()
    trace = json.load(open(tmp_path / "prof" / "trace.json"))
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "struct.dispatch" in names
    assert profile.stop() is None


def test_executor_spans_reconcile_with_stats(tmp_path):
    """The stage seconds ``ExecutorStats`` reports are the run's span
    aggregates: the sums of the emitted events agree with them."""
    from repro_torch.datastream import (Manifest, ShardExecutor,
                                        ShardRecord, ShardSource,
                                        ShardWriter)

    class SlowSource(ShardSource):
        name = "slow"

        def generate(self, rec):
            time.sleep(0.01)
            ids = np.full(rec.n_edges, rec.shard_id, np.int32)
            return {"src": ids, "dst": ids.copy()}

    n_shards, n_edges = 6, 64
    recs = [ShardRecord(i, f"shard-{i:05d}", [], n_edges)
            for i in range(n_shards)]
    manifest = Manifest(fit={}, seed=0, k_pref=0, shard_edges=n_edges,
                        num_workers=1, dtype="int32",
                        total_edges=n_shards * n_edges, n_src=1 << 20,
                        n_dst=1 << 20, bipartite=False, theta=[],
                        theta_digest="", shards=recs)
    sink = MemorySink()
    tracer = Tracer([sink])
    metrics = MetricsRegistry()
    writer = ShardWriter(str(tmp_path / "out"), manifest)
    stats = ShardExecutor(SlowSource(), writer, pipeline_depth=2,
                          host_workers=2, tracer=tracer,
                          metrics=metrics).run(manifest.shards)

    def total(name):
        return sum(e["dur"] for e in sink.spans(name))

    assert total("struct") == pytest.approx(stats.struct_s, abs=1e-9)
    assert total("write") == pytest.approx(stats.write_s, abs=1e-9)
    assert total("stall.host") + total("stall.write") == pytest.approx(
        stats.stall_s, abs=1e-9)
    run = sink.spans("run")[0]
    assert run["dur"] <= stats.wall_s
    assert {e["tid"] for e in sink.spans("write")} == {"shard-flush"}
    by_id = {e["id"]: e for e in sink.spans()}
    journals = sink.spans("write.journal")
    assert len(journals) == n_shards
    assert all(by_id[j["parent"]]["name"] == "write" for j in journals)
    assert metrics.counter("writer.rows_written").value \
        == n_shards * n_edges
    assert metrics.counter("writer.shards_committed").value == n_shards
    assert metrics.histogram("writer.commit_latency_s").count == n_shards


def test_job_spans_name_the_stages(tmp_path):
    """A featured job on the CPU reports struct, feat, align and write
    spans on their own threads; ``job.timings`` equals their sums."""
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.features import GANConfig, GANFeatureGenerator
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream import DatasetJob, FeatureSpec
    from repro_torch.tabular.schema import infer_schema
    rng = np.random.default_rng(0)
    cont = rng.normal(size=(200, 1)).astype(np.float32)
    cat = rng.integers(0, 2, size=(200, 1)).astype(np.int32)
    schema = infer_schema(cont, cat)
    gan = GANFeatureGenerator(schema, GANConfig(batch=32),
                              device="cpu").fit(cont, cat, steps=2)
    sink = MemorySink()
    job = DatasetJob(KroneckerFit(0.45, 0.22, 0.2, 0.13, 9, 9, 6000),
                     str(tmp_path / "ds"), shard_edges=2048,
                     features=FeatureSpec(gan, RandomAligner(schema)),
                     pipeline_depth=2, host_workers=2, device="cpu",
                     tracer=Tracer([sink]), backend="reference")
    job.run()
    t = job.timings
    for name, key in (("struct", "gen_struct_s"), ("feat", "gen_feat_s"),
                      ("align", "gen_align_s"), ("write", "write_s")):
        spans = sink.spans(name)
        assert spans, name
        assert sum(e["dur"] for e in spans) == pytest.approx(t[key],
                                                             abs=1e-9)
    assert {e["tid"] for e in sink.spans("feat")} <= {
        f"shard-feat_{i}" for i in range(2)}
    assert sink.spans("struct.dispatch")
