"""``repro_torch.obs`` — tracing, metrics and profiling for the pipeline.

* ``trace``   — span tracer (``tracer.span("struct", shard=k)``) with
  thread-aware nesting, monotonic clocks, per-name busy aggregation and
  near-zero cost when disabled (``NULL_TRACER``).  The executor and
  pipeline stage timings (``gen_struct_s``/``gen_feat_s``/
  ``gen_align_s``/``gen_write_s``/``gen_overlap``) are derived from
  these spans.
* ``metrics`` — counter/gauge/histogram registry (rows written, bytes
  flushed, queue depth, backpressure stalls, shard commit latency with
  p50/p95/p99) plus the versioned ``--metrics-out`` envelope
  (``bench_envelope``: schema version, git SHA, host, torch, CUDA, the
  card and its power limit).
* ``export``  — Chrome-trace / Perfetto export of an event log
  (``python -m repro_torch.scripts.report_run TRACE --perfetto OUT``).
* ``sinks``   — in-memory (tests) and crash-tolerant JSONL event logs
  (written next to the dataset manifest by ``--trace``).
* ``profile`` — optional ``torch.profiler`` session with named ranges
  over the hot path's device work (``--torch-profile``).
"""
from repro_torch.obs.metrics import (SCHEMA_VERSION, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     bench_envelope, run_env, write_bench)
from repro_torch.obs.sinks import (JsonlSink, MemorySink, iter_events,
                                   load_events)
from repro_torch.obs.trace import NULL_TRACER, NullTracer, Span, Tracer

__all__ = [
    "Tracer", "NullTracer", "NULL_TRACER", "Span",
    "MetricsRegistry", "Counter", "Gauge", "Histogram",
    "MemorySink", "JsonlSink", "load_events", "iter_events",
    "bench_envelope", "write_bench", "run_env", "SCHEMA_VERSION",
]
