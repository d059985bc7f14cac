"""The dry-run and roofline tables, from the port's dry-run JSONs: the
port of the JAX package's ``benchmarks/roofline.py``.

    python -m repro_torch.launch.dryrun --all --mesh both
    python -m repro_torch.benchmarks.run --only roofline [--device cpu]

reads ``results/dryrun_torch/*.json`` (``launch/dryrun.py``; no card
needed).  ``dryrun_table`` and ``roofline_table`` print the reference's
tables, with its column names, from the port's keys: the collectives of
the eager step (``collectives``, the reference's ``collectives_scan_hlo``),
the probe's seconds in the compile column (``t_probe_s``), and the
counted FLOPs (``counted_flops_total``) under ``HLO_FLOPs``.
"""
from __future__ import annotations

import glob
import json
from typing import Dict, List

from repro_torch.benchmarks.common import emit, row

DRYRUN_DIR = "results/dryrun_torch"


def load_cells(pattern: str = f"{DRYRUN_DIR}/*.json") -> List[Dict]:
    cells = []
    for p in sorted(glob.glob(pattern)):
        with open(p) as f:
            cells.append(json.load(f))
    return cells


def fmt_bytes(b):
    return f"{b / 2**30:.2f}GiB"


def dryrun_table(cells) -> str:
    lines = ["| arch | shape | mesh | status | mem/dev | compile | "
             "collectives (scan HLO) |",
             "|---|---|---|---|---|---|---|"]
    for c in cells:
        if c.get("tag") or c.get("arch") == "graphgen-rmat":
            continue
        if c["status"] == "ok":
            ma = c["memory_analysis"]
            peak = ma.get("peak_bytes_per_device")
            if peak is None:
                peak = (ma.get("argument_bytes", 0)
                        + (ma.get("temp_bytes") or 0))
            coll = c.get("collectives", {}).get("counts", {})
            coll_s = ",".join(f"{k}:{v}" for k, v in sorted(coll.items()))
            lines.append(
                f"| {c['arch']} | {c['shape']} | {c['mesh']} | ok | "
                f"{fmt_bytes(peak)} | "
                f"{c.get('t_probe_s', '?')}s | {coll_s} |")
        elif c["status"] == "skipped":
            lines.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                         f"SKIP | — | — | {c['reason'][:60]}... |")
        else:
            lines.append(f"| {c['arch']} | {c['shape']} | {c['mesh']} | "
                         f"ERROR | — | — | {c.get('error', '')[:60]} |")
    return "\n".join(lines)


def roofline_table(cells) -> str:
    lines = ["| arch | shape | compute s | memory s | collective s | dominant "
             "| MODEL_FLOPS | HLO_FLOPs | useful | one-line fix |",
             "|---|---|---|---|---|---|---|---|---|---|"]
    for c in cells:
        if (c.get("tag") or c.get("mesh") != "single"
                or c.get("arch") == "graphgen-rmat" or "config" not in c):
            continue
        rl = c.get("roofline")
        if not rl:
            continue
        fix = _suggest_fix(c)
        lines.append(
            f"| {c['arch']} | {c['shape']} | {rl['compute_s']*1e3:.1f}ms | "
            f"{rl['memory_s']*1e3:.1f}ms | {rl['collective_s']*1e3:.1f}ms | "
            f"**{rl['dominant']}** | {rl['model_flops']:.2e} | "
            f"{rl['counted_flops_total']:.2e} | {rl['useful_ratio']:.2f} | "
            f"{fix} |")
    return "\n".join(lines)


def _suggest_fix(c) -> str:
    rl = c["roofline"]
    dom = rl["dominant"]
    if dom == "memory":
        return ("flash-attention kernel keeps S×T scores in VMEM"
                if c["shape"] != "decode_32k" and c["config"]["family"]
                not in ("ssm",) else "fuse cache update + quantize KV cache")
    if dom == "collective":
        if c["config"]["family"] == "moe":
            return "EP all-to-all path replaces per-expert TP all-reduce"
        return "overlap all-reduce with backward (async collectives)"
    if rl["useful_ratio"] < 0.6:
        return "reduce remat recompute (dots-saveable policy)"
    return "near roofline; tune block shapes"


def run(fast: bool = True, device="cuda"):
    """The rows of the port's dry-run cells (the dry-run runs on the host:
    ``device`` selects nothing here)."""
    cells = load_cells()
    rows = []
    ok = sum(1 for c in cells if c["status"] == "ok")
    err = sum(1 for c in cells if c["status"] == "error")
    skip = sum(1 for c in cells if c["status"] == "skipped")
    rows.append(row("roofline/cells", 0.0, f"ok={ok};skip={skip};err={err}"))
    for c in cells:
        rl = c.get("roofline")
        if rl and not c.get("tag"):
            u = rl.get("useful_ratio")
            rows.append(row(
                f"roofline/{c['arch']}/{c['shape']}/{c['mesh']}", 0.0,
                f"dom={rl['dominant']}"
                + (f";useful={u:.2f}" if u is not None else "")))
    return emit(rows, "roofline")
