"""Per-stage breakdown of a ``--trace`` event log.

    PYTHONPATH=src python -m repro_torch.scripts.report_run \
        /tmp/ds/trace.jsonl
    PYTHONPATH=src python -m repro_torch.scripts.report_run \
        /tmp/ds/trace.jsonl --perfetto /tmp/ds/trace.chrome.json

Reads the crash-safe JSONL span log a ``--trace`` run writes
(``repro_torch.scripts.generate_dataset`` /
``repro_torch.scripts.fit_dataset``) and reports:

* busy seconds per stage (``struct``/``feat``/``align``/``write``/…,
  sub-spans rolled up under their dotted prefix), span counts and mean
  durations,
* the overlap factor (stage busy time / wall time — >1 means the
  pipeline actually hid host or IO time behind the device), and
* queue-stall attribution: how long the commit path sat blocked waiting
  on the host feature stage (``stall.host``) vs on a write-queue slot
  (``stall.write``) — i.e. *which* stage to widen next.

``--perfetto OUT`` additionally converts the log to Chrome trace-event
JSON (load in https://ui.perfetto.dev or chrome://tracing) where the
three overlapped executor stages render as parallel tracks.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional

#: stages whose busy time defines the overlap factor (matches
#: ExecutorStats.busy_s; stalls are waiting, not work)
BUSY_STAGES = ("struct", "feat", "align", "write")


def summarize(events: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Reduce an event list to the report dict.

    Only *top-level* occurrences of a name count toward its total:
    sub-spans (``struct.dispatch`` under ``struct``) and the enclosing
    ``run`` span are reported separately, never double-counted.
    """
    spans = [e for e in events if e.get("ev") == "span"]
    stages: Dict[str, Dict[str, float]] = {}
    t_min, t_max = float("inf"), float("-inf")
    run_dur: Optional[float] = None
    for s in spans:
        name, dur, ts = s["name"], float(s["dur"]), float(s["ts"])
        t_min = min(t_min, ts)
        t_max = max(t_max, ts + dur)
        if name == "run":
            # several run spans (resume legs) sum to total wall
            run_dur = (run_dur or 0.0) + dur
            continue
        st = stages.setdefault(name, {"busy_s": 0.0, "count": 0})
        st["busy_s"] += dur
        st["count"] += 1
    for st in stages.values():
        st["mean_s"] = st["busy_s"] / st["count"]
    wall_s = run_dur if run_dur is not None else (
        t_max - t_min if spans else 0.0)

    def total(prefix: str) -> float:
        # exact stage name only — dotted children are nested inside it
        return stages.get(prefix, {}).get("busy_s", 0.0)

    busy_s = sum(total(k) for k in BUSY_STAGES)
    stall_host = total("stall.host")
    stall_write = total("stall.write")
    stall_s = stall_host + stall_write
    return {
        "n_events": len(events),
        "n_spans": len(spans),
        "wall_s": wall_s,
        "busy_s": busy_s,
        "overlap": (busy_s / wall_s if wall_s > 0 else 0.0),
        "stages": {k: stages[k] for k in sorted(stages)},
        "stage_s": {k: total(k) for k in BUSY_STAGES},
        "stall": {
            "total_s": stall_s,
            "host_s": stall_host,
            "write_s": stall_write,
            "bottleneck": ("host" if stall_host > stall_write else
                           "write" if stall_write > 0 else None),
        },
    }


def format_report(rep: Dict[str, Any]) -> str:
    lines = [f"{rep['n_spans']} spans over {rep['wall_s']:.2f}s wall  "
             f"(busy {rep['busy_s']:.2f}s, overlap {rep['overlap']:.2f}x)",
             "", f"{'stage':<24}{'busy s':>10}{'count':>8}{'mean ms':>10}"]
    for name, st in rep["stages"].items():
        lines.append(f"{name:<24}{st['busy_s']:>10.3f}{st['count']:>8}"
                     f"{st['mean_s'] * 1e3:>10.2f}")
    stall = rep["stall"]
    lines.append("")
    if stall["total_s"] >= 0.01:
        lines.append(
            f"stalled {stall['total_s']:.2f}s — host (feature stage) "
            f"{stall['host_s']:.2f}s, write queue {stall['write_s']:.2f}s"
            + (f"; widen the {stall['bottleneck']} stage first"
               if stall["bottleneck"] else ""))
    else:
        lines.append("no significant pipeline stalls recorded")
    return "\n".join(lines)


def merge_reports(reps: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Cluster-wide rollup of per-worker reports: busy seconds and
    stalls sum across workers, wall is the *slowest* worker (the
    workers ran concurrently), so ``overlap`` becomes the cluster's
    effective parallelism (2 fully-busy workers → ~2.0)."""
    wall_s = max((r["wall_s"] for r in reps), default=0.0)
    busy_s = sum(r["busy_s"] for r in reps)
    stall_host = sum(r["stall"]["host_s"] for r in reps)
    stall_write = sum(r["stall"]["write_s"] for r in reps)
    return {
        "n_workers": len(reps),
        "n_spans": sum(r["n_spans"] for r in reps),
        "wall_s": wall_s,
        "busy_s": busy_s,
        "overlap": (busy_s / wall_s if wall_s > 0 else 0.0),
        "stage_s": {k: sum(r["stage_s"][k] for r in reps)
                    for k in BUSY_STAGES},
        "stall": {
            "total_s": stall_host + stall_write,
            "host_s": stall_host,
            "write_s": stall_write,
            "bottleneck": ("host" if stall_host > stall_write else
                           "write" if stall_write > 0 else None),
        },
    }


def format_cluster_report(names: List[str], reps: List[Dict[str, Any]],
                          merged: Dict[str, Any]) -> str:
    lines = [f"cluster: {merged['n_workers']} worker traces, "
             f"{merged['n_spans']} spans, wall {merged['wall_s']:.2f}s "
             f"(slowest worker), busy {merged['busy_s']:.2f}s, "
             f"parallelism {merged['overlap']:.2f}x",
             "", f"{'worker':<28}{'wall s':>9}{'busy s':>9}"
                 f"{'overlap':>9}{'stall s':>9}"]
    for name, r in zip(names, reps):
        lines.append(f"{name:<28}{r['wall_s']:>9.2f}{r['busy_s']:>9.2f}"
                     f"{r['overlap']:>9.2f}"
                     f"{r['stall']['total_s']:>9.2f}")
    lines += ["", f"{'stage':<28}" + "".join(
        f"{k + ' s':>10}" for k in BUSY_STAGES)]
    for name, r in zip(names, reps):
        lines.append(f"{name:<28}" + "".join(
            f"{r['stage_s'][k]:>10.2f}" for k in BUSY_STAGES))
    lines.append(f"{'(all workers)':<28}" + "".join(
        f"{merged['stage_s'][k]:>10.2f}" for k in BUSY_STAGES))
    stall = merged["stall"]
    lines.append("")
    if stall["total_s"] >= 0.01:
        lines.append(
            f"stalled {stall['total_s']:.2f}s across workers — host "
            f"(feature stage) {stall['host_s']:.2f}s, write queue "
            f"{stall['write_s']:.2f}s"
            + (f"; widen the {stall['bottleneck']} stage first"
               if stall["bottleneck"] else ""))
    else:
        lines.append("no significant pipeline stalls recorded")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("traces", nargs="+", metavar="trace",
                    help="JSONL event log(s) from a --trace run; pass "
                         "each worker's trace.w{k}.jsonl of a "
                         "--num-workers run for the merged cluster "
                         "report")
    ap.add_argument("--perfetto", default=None, metavar="OUT",
                    help="also write Chrome trace-event JSON for "
                         "ui.perfetto.dev / chrome://tracing (multiple "
                         "traces merge as one process track each)")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)

    import os

    from repro_torch.obs import load_events
    from repro_torch.obs.export import to_chrome_trace

    per_trace = []
    for path in args.traces:
        try:
            events = load_events(path)
        except OSError as e:
            raise SystemExit(f"error: {e}")
        if not events:
            raise SystemExit(f"error: no events in {path}")
        per_trace.append((path, events))
    names = [os.path.basename(p) for p, _ in per_trace]
    reps = [summarize(evs) for _, evs in per_trace]
    if len(reps) == 1:
        out: Dict[str, Any] = reps[0]
        text = format_report(reps[0])
    else:
        out = {"workers": dict(zip(names, reps)),
               "merged": merge_reports(reps)}
        text = format_cluster_report(names, reps, out["merged"])
    if args.json:
        json.dump(out, sys.stdout, indent=1)
        print()
    else:
        print(text)
    if args.perfetto:
        merged_events: List[Dict[str, Any]] = []
        for pid, (path, events) in enumerate(per_trace, start=1):
            # each trace renders as its own process track; the meta
            # event routes every span of this file to that pid
            merged_events.extend(
                to_chrome_trace([{"ev": "meta", "pid": pid}] + events,
                                process_name=names[pid - 1])
                ["traceEvents"])
        trace = {"traceEvents": merged_events, "displayTimeUnit": "ms"}
        os.makedirs(os.path.dirname(os.path.abspath(args.perfetto)),
                    exist_ok=True)
        tmp = args.perfetto + ".tmp"
        with open(tmp, "w") as f:
            json.dump(trace, f)
        os.replace(tmp, args.perfetto)
        print(f"\nperfetto: {args.perfetto} "
              f"(open in https://ui.perfetto.dev)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
