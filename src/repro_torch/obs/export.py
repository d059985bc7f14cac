"""Chrome-trace / Perfetto export of a JSONL event log.

``to_chrome_trace`` converts the tracer's span events into the Chrome
Trace Event JSON format (the ``{"traceEvents": [...]}`` flavour), which
both ``chrome://tracing`` and https://ui.perfetto.dev open directly.
Each tracer thread becomes one track, so a pipelined
``generate_dataset --trace`` run renders as a Gantt with the device
struct lane (main thread), the host feature lanes (``shard-feat-*``)
and the writer flush lane (``shard-flush``) visibly overlapped — the
picture behind the executor's ``overlap`` factor.

    PYTHONPATH=src python -m repro_torch.scripts.report_run \
        /data/ds/trace.jsonl --perfetto /tmp/ds_trace.json
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List

from repro_torch.obs.sinks import load_events

__all__ = ["to_chrome_trace", "export_chrome_trace"]


def to_chrome_trace(events: List[Dict[str, Any]],
                    process_name: str = "repro_torch") -> Dict[str, Any]:
    """Span events → Chrome Trace Event dict.  Thread names map to
    stable integer ``tid``s (in order of first appearance) with ``M``
    metadata records carrying the human names; timestamps convert from
    the tracer's relative seconds to microseconds."""
    tids: Dict[str, int] = {}
    out: List[Dict[str, Any]] = []
    pid = 1
    for ev in events:
        if ev.get("ev") == "meta" and "pid" in ev:
            pid = ev["pid"]
    out.append({"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": process_name}})
    for ev in events:
        if ev.get("ev") not in ("span", "instant"):
            continue
        tname = str(ev.get("tid", "?"))
        if tname not in tids:
            tids[tname] = len(tids) + 1
            out.append({"ph": "M", "pid": pid, "tid": tids[tname],
                        "name": "thread_name", "args": {"name": tname}})
        rec: Dict[str, Any] = {
            "name": ev.get("name", "?"),
            "cat": str(ev.get("name", "?")).split(".", 1)[0],
            "pid": pid, "tid": tids[tname],
            "ts": float(ev.get("ts", 0.0)) * 1e6,
        }
        if ev["ev"] == "span":
            rec["ph"] = "X"
            rec["dur"] = float(ev.get("dur", 0.0)) * 1e6
        else:
            rec["ph"] = "i"
            rec["s"] = "t"
        args = ev.get("args")
        if args:
            rec["args"] = args
        out.append(rec)
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def export_chrome_trace(jsonl_path: str, out_path: str,
                        process_name: str = "repro_torch") -> int:
    """Convert an event log file to a Chrome-trace file; returns the
    number of trace records written."""
    trace = to_chrome_trace(load_events(jsonl_path), process_name)
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    tmp = out_path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(trace, f)
    os.replace(tmp, out_path)
    return len(trace["traceEvents"])
