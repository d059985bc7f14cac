"""Trace event sinks: in-memory for tests, JSONL for production runs.

A sink is anything with ``emit(event: dict)`` (and optionally
``close()``).  The tracer calls ``emit`` from every pipeline thread, so
sinks serialize internally.

:class:`JsonlSink` is the durable one — an append-only event log
(one JSON object per line) written next to the dataset manifest by
``python -m repro_torch.scripts.generate_dataset --trace``.
Crash-safety mirrors the shard journal's: each event is a single buffered ``write`` of one full line,
flushed every ``flush_every`` events, and :func:`load_events` skips a
torn final line (kill mid-write) and any corrupt line instead of
failing, so a resumed job appends to the same log and the merged file
still parses.
"""
from __future__ import annotations

import json
import os
import threading
from typing import Any, Dict, Iterator, List, Optional

__all__ = ["MemorySink", "JsonlSink", "load_events", "iter_events"]


class MemorySink:
    """Keep events in a list — the test/report double."""

    def __init__(self):
        self.events: List[Dict[str, Any]] = []
        self._lock = threading.Lock()

    def emit(self, event: Dict[str, Any]) -> None:
        with self._lock:
            self.events.append(event)

    def close(self) -> None:
        return None

    def spans(self, name: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self.events)
        return [e for e in evs if e.get("ev") == "span"
                and (name is None or e.get("name") == name)]


class JsonlSink:
    """Append-only JSONL event log.

    ``append=True`` (the default) lets a resumed job extend the log of
    the run it continues; pass ``append=False`` to truncate.  Events are
    buffered and flushed every ``flush_every`` emits (and on close) —
    an event log must not add an fsync per span to the hot path it is
    observing.
    """

    def __init__(self, path: str, append: bool = True,
                 flush_every: int = 64):
        self.path = path
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "ab" if append else "wb")
        self._lock = threading.Lock()
        self._since_flush = 0
        self._flush_every = max(1, int(flush_every))

    def emit(self, event: Dict[str, Any]) -> None:
        line = json.dumps(event, separators=(",", ":")).encode() + b"\n"
        with self._lock:
            if self._f.closed:
                return
            self._f.write(line)
            self._since_flush += 1
            if self._since_flush >= self._flush_every:
                self._f.flush()
                self._since_flush = 0

    def close(self) -> None:
        with self._lock:
            if not self._f.closed:
                self._f.flush()
                self._f.close()


def iter_events(path: str) -> Iterator[Dict[str, Any]]:
    """Yield events from a JSONL log, tolerating a torn/corrupt trailing
    line (crash mid-append) and blank lines — the same partial-write
    policy as ``Manifest._replay_journal``."""
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode(errors="replace").strip()
            if not line:
                continue
            try:
                ev = json.loads(line)
            except ValueError:
                continue        # torn or corrupt record — skip, don't die
            if isinstance(ev, dict):
                yield ev


def load_events(path: str) -> List[Dict[str, Any]]:
    return list(iter_events(path))
