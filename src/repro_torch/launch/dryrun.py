"""Dry-run of every (arch × shape × mesh) cell on the production mesh,
without a card: the port of the JAX package's ``launch/dryrun.py``.

    python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
    python -m repro_torch.launch.dryrun --all --mesh both   # every cell
    python -m repro_torch.launch.dryrun --graphgen --mesh both
    python -m repro_torch.launch.dryrun --all --jobs 8     # 8 processes
    python -m repro_torch.launch.dryrun --all --shape train_4k --jobs 8

The reference lowers and compiles each cell with XLA on 512 placeholder
host devices.  The port brings up a placeholder process group of 512
ranks in this process (``launch.mesh.fake_process_group``), builds the
``(16, 16)`` or ``(2, 16, 16)`` mesh over its first 256 or all 512 ranks,
and runs each cell's eager step on ``meta`` DTensors laid out by the
sharding rules, under ``launch.costs.CostProbe`` at depth 1 and 2
(``--jobs N`` spreads every cell's probe runs over N processes; with
``--all``, ``--shape`` keeps one shape).

Each cell writes ``<out>/<arch>__<shape>__<mesh>[__<tag>].json`` with
the reference's keys where their meaning holds — ``status`` (``ok``,
``skipped`` with the reference's reason, or ``error``), ``reason``,
``config``, ``memory_analysis`` (argument, output, alias, temp and peak
bytes per device), ``probe`` and ``roofline`` (``compute_s``,
``memory_s``, ``collective_s``, ``dominant``, ``model_flops``,
``useful_ratio``) — and renames the keys whose meaning moved:
``collectives`` (was ``collectives_scan_hlo``: the eager step's own
collectives, every one of them, extrapolated in depth) and
``counted_flops_total`` (was ``hlo_flops_total``).  ``method`` says how
each figure was obtained.  The hardware model is the H100's
(``launch.mesh``: bf16 dense peak, HBM rate, ``LINK_BW``).

Departures from the reference, declared:

* ``useful_ratio`` = ``model_flops / counted_flops_total`` is not the
  reference's number: FlopCounterMode's table counts matrix products
  only, where XLA's ``cost_analysis`` counts elementwise work too;
* temp bytes are the eager step's peak live bytes, not XLA's buffer
  assignment, and memory bytes an upper bound (every op unfused);
* the multi-pod cells are probed too (the reference skips their probe in
  ``--all``): the port's memory comes from the probe.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

from repro_torch.configs import ARCHS, LM_SHAPES, SHAPES_BY_NAME, get_config
from repro_torch.launch import costs as costs_mod
from repro_torch.launch import mesh as mesh_mod

#: ranks of the placeholder group: both production meshes fit in it
WORLD = 512

METHOD = {
    "memory_analysis": "argument/output bytes: each argument's local shard "
                       "from its placements, exact; temp: the eager "
                       "step's peak live bytes on meta tensors (storage "
                       "finalizers), depth-probed and extrapolated",
    "flops": "torch.utils.flop_counter formulas (matrix products and "
             "convolutions) on each rank's local ops, depth-probed",
    "bytes": "input + output bytes of every local op of the eager step "
             "(unfused: an upper bound)",
    "collectives": "the step's c10d functional collectives on rank 0 of "
                   "a placeholder process group; link bytes all-reduce "
                   "2(n-1)/n, others (n-1)/n of the payload",
    "hardware": "H100 SXM: bf16 dense peak and HBM rate of "
                "kernels/bounds.py, launch.mesh.LINK_BW",
}


@functools.lru_cache(maxsize=2)
def _mesh(mesh_kind: str):
    mesh_mod.fake_process_group(WORLD)
    return mesh_mod.make_production_mesh(multi_pod=(mesh_kind == "multi"))


def _hardware() -> dict:
    return {"peak_flops_bf16": mesh_mod.PEAK_FLOPS_BF16,
            "hbm_bytes_per_s": mesh_mod.HBM_BW,
            "link_bytes_per_s": mesh_mod.LINK_BW}


def _write(path: str, rec: dict) -> dict:
    with open(path, "w") as f:
        json.dump(rec, f, indent=2)
    return rec


def _roofline(n_chips: int, flops: float, nbytes: float, link: float,
              **extra) -> dict:
    comp = flops / mesh_mod.PEAK_FLOPS_BF16
    mem = nbytes / mesh_mod.HBM_BW
    coll = link / mesh_mod.LINK_BW
    dom = max((comp, "compute"), (mem, "memory"), (coll, "collective"))
    return {"chips": n_chips, "compute_s": comp, "memory_s": mem,
            "collective_s": coll, "dominant": dom[1], **extra}


def memory_analysis(cell, cfg, shape, temp_bytes=None) -> dict:
    """Per-device bytes of one cell: arguments and outputs exact from
    their placements (the donated arguments alias their outputs), temp
    from the probe (None: not probed)."""
    import torch
    from repro_torch.models.params import TensorSpec, torch_dtype
    from repro_torch.training.steps import local_bytes
    arg = sum(local_bytes(a, s) for a, s in zip(cell.args,
                                                cell.in_shardings))
    donated = sum(local_bytes(cell.args[i], cell.in_shardings[i])
                  for i in cell.donate)
    B = shape.global_batch
    if shape.kind == "train":          # params, state, three scalars
        first = (TensorSpec((), torch.float32),) * 3
        first_sh = (cell.out_shardings[2][k] for k in ("loss", "lr",
                                                        "grad_norm"))
    elif shape.kind == "prefill":      # last logits, and the cache
        first = (TensorSpec((B, cfg.vocab), torch_dtype(cfg.dtype)),)
        first_sh = (cell.out_shardings[0],)
    else:                              # next tokens, and the cache
        first = (TensorSpec((B,), torch.int32),)
        first_sh = (cell.out_shardings[0],)
    out = donated + sum(local_bytes(a, s) for a, s in zip(first, first_sh))
    return {"argument_bytes": arg, "output_bytes": out,
            "alias_bytes": donated, "temp_bytes": temp_bytes,
            "peak_bytes_per_device": (None if temp_bytes is None
                                      else arg + temp_bytes)}


def _config(cfg) -> dict:
    return {"family": cfg.family, "n_layers": cfg.n_layers,
            "d_model": cfg.d_model, "microbatches": cfg.microbatches,
            "remat_policy": cfg.remat_policy, "moe_path": cfg.moe_path,
            "fsdp": cfg.fsdp, "dp2d": cfg.dp2d, "seq_shard": cfg.seq_shard}


def _cfg(arch: str, overrides):
    cfg = get_config(arch)
    if overrides:
        ov = dict(overrides)
        pad = ov.pop("__pad_vocab__", None)
        if pad is not None and cfg.vocab % pad:
            ov["vocab"] = ((cfg.vocab + pad - 1) // pad) * pad
        cfg = cfg.replace(**ov)
    return cfg


def _open_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
               overrides, tag: str):
    """The cell's record and path, and whether it is done already (a
    skipped cell)."""
    cfg = _cfg(arch, overrides)
    shape = SHAPES_BY_NAME[shape_name]
    ok, reason = cfg.supports_shape(shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "tag": tag,
           "config": _config(cfg)}
    name = f"{arch}__{shape_name}__{mesh_kind}{('__' + tag) if tag else ''}"
    path = os.path.join(out_dir, name + ".json")
    os.makedirs(out_dir, exist_ok=True)
    if not ok:
        rec.update(status="skipped", reason=reason)
        print(f"[dryrun] {name}: SKIPPED ({reason[:60]}...)")
        return _write(path, rec), path, cfg, shape, True
    return rec, path, cfg, shape, False


def _close_cell(rec: dict, path: str, cfg, shape, results, t_probe: float,
                error=None) -> dict:
    """Fill and write a cell's record from its probe runs (``results``:
    ``probe_plan``'s keys → points; None: the probe was skipped)."""
    from repro_torch.training.steps import build_cell
    name = os.path.basename(path)[:-5]
    try:
        if error is not None:
            raise error
        mesh = _mesh(rec["mesh"])
        n_chips = mesh.size()
        cell = build_cell(cfg, shape, mesh, device="meta")
        rec["method"] = dict(METHOD)
        rec["hardware"] = _hardware()
        if results is None:
            rec["memory_analysis"] = memory_analysis(cell, cfg, shape)
            rec["method"]["memory_analysis"] += " (probe skipped: no temp)"
        else:
            probe = costs_mod.probe_combine(cfg, results)
            rec["t_probe_s"] = round(t_probe, 2)
            rec["memory_analysis"] = memory_analysis(cell, cfg, shape,
                                                     probe.temp_bytes)
            rec["collectives"] = {
                "counts": probe.coll_counts,
                "bytes_by_kind": probe.coll_bytes_by_kind,
                "payload_bytes": probe.coll_payload,
                "link_bytes": probe.coll_link}
            rec["probe"] = {
                "flops_per_device": probe.flops,
                "global_flops": probe.global_flops,
                "bytes_per_device": probe.bytes,
                "temp_bytes_per_device": probe.temp_bytes,
                "coll_payload_bytes_per_device": probe.coll_payload,
                "coll_link_bytes_per_device": probe.coll_link,
                "coll_counts": probe.coll_counts}
            mf = costs_mod.model_flops(cfg, shape)
            total = probe.flops * n_chips
            rec["roofline"] = _roofline(
                n_chips, probe.flops, probe.bytes, probe.coll_link,
                model_flops=mf, counted_flops_total=total,
                useful_ratio=mf / total if total else 0.0)
            rl = rec["roofline"]
            print(f"[dryrun] {name}: compute={rl['compute_s']*1e3:.2f}ms "
                  f"memory={rl['memory_s']*1e3:.2f}ms "
                  f"coll={rl['collective_s']*1e3:.2f}ms "
                  f"dom={rl['dominant']} useful={rl['useful_ratio']:.2f}")
        rec["status"] = "ok"
        peak = rec["memory_analysis"]["peak_bytes_per_device"]
        print(f"[dryrun] {name}: OK mem/dev="
              + ("not probed" if peak is None else f"{peak / 2**30:.2f}GiB"))
    except Exception as e:  # noqa: BLE001 — record failures, keep sweeping
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = "".join(traceback.format_exception(e))[-4000:]
        print(f"[dryrun] {name}: ERROR {type(e).__name__}: {str(e)[:200]}")
    return _write(path, rec)


def _probe_run(cfg, shape, mesh_kind: str) -> tuple:
    """One run of a cell's probe (a pool task): (point, seconds)."""
    t0 = time.time()
    return costs_mod.run_probe(cfg, shape, _mesh(mesh_kind)), \
        time.time() - t0


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: str,
             overrides=None, tag: str = "", skip_probe: bool = False):
    """One cell, its probe runs in this process."""
    rec, path, cfg, shape, done = _open_cell(arch, shape_name, mesh_kind,
                                             out_dir, overrides, tag)
    if done:
        return rec
    if skip_probe:
        return _close_cell(rec, path, cfg, shape, None, 0.0)
    results, t_probe, error = {}, 0.0, None
    try:
        for name, mb, c, sh in costs_mod.probe_plan(cfg, shape):
            results[(name, mb)], dt = _probe_run(c, sh, mesh_kind)
            t_probe += dt
    except Exception as e:  # noqa: BLE001 — recorded in the cell
        error = e
    return _close_cell(rec, path, cfg, shape, results, t_probe, error)


def run_graphgen_cell(mesh_kind: str, out_dir: str, scale: str = "1t",
                      mode: str = "threefry"):
    """The paper's chunked R-MAT step on the production mesh: its work
    a device is the kernel's (``core.distributed_gen``), no collective."""
    from repro_torch.core.distributed_gen import build_generation_cell
    tag = "" if mode == "threefry" else "__uniforms_hbm"
    name = f"graphgen__{scale}__{mesh_kind}{tag}"
    path = os.path.join(out_dir, name + ".json")
    os.makedirs(out_dir, exist_ok=True)
    rec = {"arch": "graphgen-rmat", "shape": scale, "mesh": mesh_kind,
           "mode": mode}
    try:
        n_chips = 512 if mesh_kind == "multi" else 256
        cell = build_generation_cell(n_chips, scale, mode=mode)
        c = cell.costs
        rec.update(
            status="ok",
            method={"costs": "the kernel's operations and bytes from "
                             "kernels/bounds.py, per device",
                    "collectives": "none: each device draws its own ids"},
            hardware=_hardware(),
            memory_analysis={"argument_bytes": c["argument_bytes"],
                             "temp_bytes": 0,
                             "output_bytes": c["output_bytes"]},
            costs={k: c[k] for k in ("kernel", "operations", "bytes")},
            collectives=costs_mod.summarize_collectives([]))
        rl = _roofline(n_chips, 0.0, 0.0, 0.0)
        comp, mem = c["operations_s"], c["bytes_s"]
        rl.update(compute_s=comp, memory_s=mem,
                  dominant=max((comp, "compute"), (mem, "memory"),
                               (0.0, "collective"))[1],
                  edges=cell.meta["edges"],
                  edges_per_s_roofline=(cell.meta["edges"] / max(comp, mem)
                                        if max(comp, mem) else 0))
        rec["roofline"] = rl
        rec["meta"] = cell.meta
        print(f"[dryrun] {name}: OK edges={cell.meta['edges']:.2e} "
              f"compute={comp*1e3:.2f}ms mem={mem*1e3:.2f}ms coll=0")
    except Exception as e:  # noqa: BLE001
        rec.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] {name}: ERROR {str(e)[:200]}")
    return _write(path, rec)


def _cells(args) -> list:
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        return [(arch, sh.name, mk) for mk in meshes for arch in ARCHS
                for sh in LM_SHAPES if args.shape in (None, sh.name)]
    if not (args.arch and args.shape):
        raise SystemExit("dryrun: --arch and --shape (or --all, "
                         "--graphgen)")
    return [(args.arch, args.shape, mk) for mk in meshes]


def _overrides(args) -> dict:
    ov = {}
    for key, val in (("microbatches", args.microbatches),
                     ("remat_policy", args.remat_policy),
                     ("moe_path", args.moe_path),
                     ("attn_scores_dtype", args.attn_scores_dtype)):
        if val is not None:
            ov[key] = val
    for key in ("seq_shard", "dp2d", "fsdp"):
        if getattr(args, key):
            ov[key] = True
    if args.pad_vocab is not None:
        ov["__pad_vocab__"] = args.pad_vocab
    return ov


def _cost_rank(cfg, shape) -> tuple:
    """Sort key putting a probe run's likely length first: the chunked
    families' scans, then the deeper, longer and more microbatched."""
    return (cfg.family not in ("ssm", "hybrid"), -cfg.n_layers,
            -shape.seq_len, -cfg.microbatches)


def _run_many(cells, args) -> None:
    """The cells in this process, or every probe run of every cell over
    ``--jobs`` processes (each brings up its own placeholder group)."""
    ov = _overrides(args)
    if args.jobs <= 1:
        for arch, sh, mk in cells:
            run_cell(arch, sh, mk, args.out, ov, args.tag,
                     skip_probe=args.skip_probe)
        return
    import multiprocessing as mp
    opened = [(_open_cell(arch, sh, mk, args.out, ov, args.tag), mk)
              for arch, sh, mk in cells]
    todo = [] if args.skip_probe else sorted(
        ((i, name, mb, c, s, mk)
         for i, ((rec, path, cfg, shape, done), mk) in enumerate(opened)
         if not done for name, mb, c, s in costs_mod.probe_plan(cfg, shape)),
        key=lambda t: _cost_rank(t[3], t[4]))
    with mp.get_context("spawn").Pool(args.jobs) as pool:
        tasks = [None if done or args.skip_probe else {}
                 for (rec, path, cfg, shape, done), mk in opened]
        for i, name, mb, c, s, mk in todo:     # the longest runs first
            tasks[i][(name, mb)] = pool.apply_async(_probe_run, (c, s, mk))
        for ((rec, path, cfg, shape, done), mk), runs in zip(opened, tasks):
            if done:
                continue
            if runs is None:
                _close_cell(rec, path, cfg, shape, None, 0.0)
                continue
            results, t_probe, error = {}, 0.0, None
            for key, r in runs.items():
                try:
                    results[key], dt = r.get()
                    t_probe += dt
                except Exception as e:  # noqa: BLE001 — recorded
                    error = error or e
            _close_cell(rec, path, cfg, shape, results, t_probe, error)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--graphgen", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--skip-probe", action="store_true")
    ap.add_argument("--microbatches", type=int, default=None)
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--moe-path", default=None)
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--pad-vocab", type=int, default=None,
                    help="pad vocab up to a multiple of N (sharding fix)")
    ap.add_argument("--dp2d", action="store_true",
                    help="FSDP-2D: batch over both axes, ZeRO-3 weights")
    ap.add_argument("--fsdp", action="store_true")
    ap.add_argument("--attn-scores-dtype", default=None)
    ap.add_argument("--gen-mode", default="threefry",
                    choices=["threefry", "hbm_uniforms"])
    ap.add_argument("--jobs", type=int, default=1,
                    help="probe runs in this many processes at once")
    args = ap.parse_args(argv)
    if args.graphgen:
        for mk in (["single", "multi"] if args.mesh == "both"
                   else [args.mesh]):
            run_graphgen_cell(mk, args.out, mode=args.gen_mode)
        return
    _run_many(_cells(args), args)


if __name__ == "__main__":
    main()
