"""Span-based tracing for the generation hot path.

A :class:`Tracer` hands out context-manager spans::

    with tracer.span("struct", shard=k):
        arrays = source.generate(rec)

Every span is measured on the monotonic clock (``time.perf_counter``)
and does two things on exit:

* **aggregates** — busy seconds and call counts per span name accumulate
  under one lock (the numbers ``ExecutorStats`` and ``job.timings`` are
  derived from);
* **emits** — if any sink is attached (``repro_torch.obs.sinks``), a flat
  event dict with start/duration/thread/nesting lands in each sink.

Nesting is thread-aware: each thread keeps its own span stack in
thread-local storage, so the executor's struct spans (caller thread),
host feature spans (``shard-feat`` pool threads) and writer flush spans
(``shard-flush`` thread) nest independently and carry their own ``tid``.

A span times the host: work queued on the card is counted where the host
waits for it (a copy to the host, a synchronize), not where it is
launched.  ``repro_torch.obs.profile`` names the same regions in a
``torch.profiler`` trace for the device's side.

Overhead: a sink-less tracer costs two ``perf_counter`` calls plus one
locked dict update per span.  The module-level :data:`NULL_TRACER` is
cheaper still: ``span()`` returns a shared no-op context manager and
touches no clock, no lock and no allocation.
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import Any, Dict, List, Optional

__all__ = ["Span", "Tracer", "NullTracer", "NULL_TRACER"]


class Span:
    """One closed span: measured interval + identity.  ``ts``/``dur`` are
    seconds on the tracer's monotonic clock, relative to the tracer's
    epoch (its construction instant) so events from different threads
    share one timeline."""

    __slots__ = ("name", "ts", "dur", "tid", "span_id", "parent_id",
                 "attrs")

    def __init__(self, name: str, ts: float, dur: float, tid: str,
                 span_id: int, parent_id: Optional[int],
                 attrs: Optional[Dict[str, Any]]):
        self.name = name
        self.ts = ts
        self.dur = dur
        self.tid = tid
        self.span_id = span_id
        self.parent_id = parent_id
        self.attrs = attrs

    def to_event(self) -> Dict[str, Any]:
        ev = {"ev": "span", "name": self.name, "ts": self.ts,
              "dur": self.dur, "tid": self.tid, "id": self.span_id}
        if self.parent_id is not None:
            ev["parent"] = self.parent_id
        if self.attrs:
            ev["args"] = self.attrs
        return ev


class _SpanCtx:
    """The live (open) span handle ``Tracer.span`` returns.  After exit,
    ``dur`` holds the measured seconds — callers that also need the
    number (e.g. ``FeatureSpec`` mirroring its stage accumulators) read
    it instead of timing the region twice."""

    __slots__ = ("_tracer", "name", "attrs", "_t0", "dur", "span_id",
                 "parent_id")

    def __init__(self, tracer: "Tracer", name: str,
                 attrs: Optional[Dict[str, Any]]):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.dur = 0.0
        self.span_id = 0
        self.parent_id = None

    def __enter__(self) -> "_SpanCtx":
        tr = self._tracer
        stack = tr._stack()
        self.parent_id = stack[-1].span_id if stack else None
        self.span_id = next(tr._ids)
        stack.append(self)
        self._t0 = tr._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        tr = self._tracer
        t1 = tr._clock()
        self.dur = t1 - self._t0
        stack = tr._stack()
        if stack and stack[-1] is self:
            stack.pop()
        tr._record(self, self._t0 - tr._epoch)
        return None


class _NullCtx:
    """Shared no-op context manager — the whole disabled-mode cost."""

    __slots__ = ()
    dur = 0.0

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_NULL_CTX = _NullCtx()


class Tracer:
    """Thread-safe span tracer with per-name aggregation and optional
    sink emission.

    ``sinks``: objects with ``emit(event: dict)`` (and optionally
    ``close()``) — see ``repro_torch.obs.sinks``.  With no sinks the tracer
    only aggregates (cheap); attach a sink to get the event log.
    """

    def __init__(self, sinks: Optional[List] = None,
                 clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self._unix_epoch = time.time()
        self._sinks: List = []
        self._lock = threading.Lock()
        self._totals: Dict[str, float] = {}
        self._counts: Dict[str, int] = {}
        self._tls = threading.local()
        self._ids = itertools.count(1)
        for s in sinks or ():
            self.add_sink(s)

    # -- sinks -------------------------------------------------------------
    def add_sink(self, sink) -> None:
        sink.emit({"ev": "meta", "unix_t0": self._unix_epoch,
                   "pid": os.getpid(),
                   "clock_offset": self._clock() - self._epoch})
        with self._lock:
            self._sinks.append(sink)

    @property
    def emitting(self) -> bool:
        return bool(self._sinks)

    def close(self) -> None:
        """Flush and close every sink (idempotent)."""
        with self._lock:
            sinks, self._sinks = self._sinks, []
        for s in sinks:
            close = getattr(s, "close", None)
            if close is not None:
                close()

    # -- spans -------------------------------------------------------------
    def span(self, name: str, **attrs) -> _SpanCtx:
        return _SpanCtx(self, name, attrs or None)

    def _stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def _record(self, ctx: _SpanCtx, ts: float) -> None:
        name = ctx.name
        with self._lock:
            self._totals[name] = self._totals.get(name, 0.0) + ctx.dur
            self._counts[name] = self._counts.get(name, 0) + 1
            sinks = tuple(self._sinks)
        if sinks:
            ev = Span(name, ts, ctx.dur, threading.current_thread().name,
                      ctx.span_id, ctx.parent_id, ctx.attrs).to_event()
            for s in sinks:
                s.emit(ev)

    def event(self, name: str, **attrs) -> None:
        """Emit a zero-duration instant event (sinks only — it does not
        touch the per-name busy aggregates)."""
        with self._lock:
            sinks = tuple(self._sinks)
        if not sinks:
            return
        ev = {"ev": "instant", "name": name,
              "ts": self._clock() - self._epoch,
              "tid": threading.current_thread().name}
        if attrs:
            ev["args"] = attrs
        for s in sinks:
            s.emit(ev)

    # -- aggregates --------------------------------------------------------
    def total(self, name: str) -> float:
        """Accumulated busy seconds of every closed span called ``name``."""
        with self._lock:
            return self._totals.get(name, 0.0)

    def count(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def totals(self) -> Dict[str, float]:
        """Snapshot of all per-name busy totals — diff two snapshots to
        scope aggregation to one run (several runs may share a tracer)."""
        with self._lock:
            return dict(self._totals)


class NullTracer:
    """Disabled tracing: every ``span()`` returns one shared no-op
    context manager; aggregates read as zero.  Near-zero overhead —
    instrument unconditionally, pass ``NULL_TRACER`` to turn it off."""

    emitting = False

    def span(self, name: str, **attrs) -> _NullCtx:
        return _NULL_CTX

    def event(self, name: str, **attrs) -> None:
        return None

    def add_sink(self, sink) -> None:
        raise ValueError("NullTracer cannot emit — use a Tracer")

    def close(self) -> None:
        return None

    def total(self, name: str) -> float:
        return 0.0

    def count(self, name: str) -> int:
        return 0

    def totals(self) -> Dict[str, float]:
        return {}


#: the shared disabled tracer — instrumented code defaults to this
NULL_TRACER = NullTracer()
