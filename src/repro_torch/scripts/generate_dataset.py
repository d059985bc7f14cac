"""Materialize a synthetic graph dataset to disk (repro_torch.datastream).

    python -m repro_torch.scripts.generate_dataset \\
        --fit demo --edges 1e7 --shard-edges 1e6 --out /data/ds

    python -m repro_torch.scripts.generate_dataset \\
        --asset src/repro_torch/assets/tabformer_like_fit.npz \\
        --scale-nodes 16 --shard-edges '1<<21' --out /data/ds --verify

Runs on the CUDA card unless ``--device cpu`` is given.  Interrupt it
(Ctrl-C / SIGKILL) and re-run with ``--resume``: finished shards are
skipped and the remainder is regenerated deterministically, byte for
byte.  ``--fit`` takes the built-in ``demo`` θ or a path to a JSON file
with KroneckerFit fields ({"a":..,"b":..,"c":..,"d":..,"n":..,"m":..,
"E":..}) and writes structure only; ``--asset`` takes a saved fit
(``repro_torch.convert.save_state``) and writes its features and
alignment beside the structure.  The output is the JAX package's format.

``--num-workers K`` plans once and stripes the plan across K spawned
worker processes (``repro_torch.distributed.cluster``), each running
``python -m repro_torch.scripts.generate_dataset ... --worker-id k``;
their journals merge into the one manifest, byte-identical to the
single-process run.  On one card the workers share it.  With ``--trace``
each worker writes ``trace.w{k}.jsonl`` (``--metrics-out M.json``:
``M.w{k}.json``); ``python -m repro_torch.scripts.report_run
OUT/trace.w*.jsonl`` merges them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time


def build_fit(args):
    """The ``KroneckerFit`` of ``--fit`` (struct only), scaled by
    ``--scale-nodes``, with ``--edges``/``--noise`` applied."""
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.utils import parse_count
    E = parse_count(args.edges) if args.edges else None
    if args.fit == "demo":
        if E is None:
            raise SystemExit("--fit demo needs --edges")
        # avg degree 8 demo graph: 2^n nodes per partite
        n = max(4, math.ceil(math.log2(max(E // 8, 16))))
        return KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=n, m=n, E=E,
                            noise=args.noise)
    with open(args.fit) as f:
        d = json.load(f)
    if isinstance(d.get("fit"), dict):
        d = d["fit"]            # a fit + provenance file
    fit = KroneckerFit(**d).scaled(args.scale_nodes)
    return _override(fit, args, E)


def _override(fit, args, E):
    if E is not None:
        fit = dataclasses.replace(fit, E=E)
    if args.noise:
        fit = dataclasses.replace(fit, noise=args.noise)
    return fit


def build_asset(args):
    """``(fit, FeatureSpec or None)`` of ``--asset``: the saved pipeline's
    structure scaled by ``--scale-nodes``, and its GAN + aligner on
    ``--device`` when its features are edge features."""
    from repro_torch import convert
    from repro_torch.datastream import FeatureSpec
    from repro_torch.utils import parse_count
    pipe = convert.pipeline_from_state(convert.load_state(args.asset),
                                       device=args.device)
    E = parse_count(args.edges) if args.edges else None
    fit = _override(pipe.struct.scaled(args.scale_nodes), args, E)
    features = (FeatureSpec(pipe.features, pipe.aligner)
                if pipe.feature_kind == "edge" else None)
    return fit, features


def plan_asset(args):
    """``build_asset`` for the coordinator: the fit loaded on the CPU
    (the coordinator makes no CUDA context; each worker holds its own on
    the card), its features planned on the workers' ``--device``."""
    from repro_torch.datastream import FeatureSpec
    fit, features = build_asset(argparse.Namespace(**dict(
        vars(args), device="cpu")))
    if features is not None:
        features = FeatureSpec(features.generator, features.aligner,
                               device=args.device)
    return fit, features


def worker_path(path: str, worker_id: int) -> str:
    """Namespace a per-run artifact path for one worker process:
    ``trace.jsonl`` -> ``trace.w0.jsonl``."""
    root, ext = os.path.splitext(path)
    return f"{root}.w{int(worker_id)}{ext}"


def worker_flags(args, worker_id: int, num_workers: int) -> list:
    """Rebuild the CLI flags for one spawned worker stripe from the
    coordinator's parsed args.  Everything byte-relevant (fit or asset,
    scale, seed, shard size, mode, backend, dtype, device) passes through
    unchanged; the stripe is selected by ``--num-workers/--worker-id``;
    per-worker artifacts (trace, metrics, profile) keep the parent's flag
    and are namespaced by the worker itself."""
    flags = (["--asset", args.asset] if args.asset
             else ["--fit", args.fit])
    flags += ["--out", args.out,
              "--scale-nodes", str(args.scale_nodes),
              "--shard-edges", args.shard_edges,
              "--seed", str(args.seed), "--mode", args.mode,
              "--device", args.device,
              "--num-workers", str(num_workers),
              "--worker-id", str(worker_id),
              "--pipeline-depth", str(args.pipeline_depth),
              "--host-workers", str(args.host_workers)]
    if args.edges:
        flags += ["--edges", args.edges]
    if args.k_pref is not None:
        flags += ["--k-pref", str(args.k_pref)]
    if args.noise:
        flags += ["--noise", str(args.noise)]
    if args.backend:
        flags += ["--backend", args.backend]
    if args.id_dtype:
        flags += ["--id-dtype", args.id_dtype]
    if args.max_shards is not None:
        flags += ["--max-shards", str(args.max_shards)]
    if args.fused:
        flags += ["--fused"]
    if args.serial:
        flags += ["--serial"]
    if args.trace is not None:
        flags += (["--trace"] if args.trace == "auto"
                  else ["--trace", args.trace])
    if args.metrics_out:
        flags += ["--metrics-out", args.metrics_out]
    if args.torch_profile:
        flags += ["--torch-profile", args.torch_profile]
    return flags


def run_cluster(args, job, kill_after=None) -> int:
    """Coordinator mode: plan once, stripe across ``--num-workers``
    spawned processes, merge journals into the one manifest.
    ``kill_after`` (``{worker_id: shards}``) is the coordinator's
    fault-injection hook."""
    from repro_torch.datastream import Manifest, ShardedGraphDataset
    from repro_torch.distributed.cluster import (ClusterCoordinator,
                                                 ClusterError)
    from repro_torch.distributed.launcher import python_argv

    if args.resume and Manifest.exists(args.out):
        job._load_validated()      # refuse resumes that change streams
    else:
        try:
            job.plan(overwrite=args.resume)
        except FileExistsError:
            raise SystemExit(
                f"error: {args.out} already holds a dataset — pass "
                "--resume to continue it, or choose a different --out")
    coord = ClusterCoordinator(
        args.out,
        lambda w, W: python_argv("-m", "repro_torch.scripts."
                                 "generate_dataset",
                                 *worker_flags(args, w, W)),
        num_workers=args.num_workers, kill_after=kill_after,
        log=lambda msg: print(f"cluster: {msg}", file=sys.stderr))
    t0 = time.time()
    try:
        manifest = coord.run()
    except ClusterError as e:
        raise SystemExit(f"error: {e}")
    dt = time.time() - t0
    done = manifest.done_edges()
    rounds = coord.report["rounds"]
    print(f"cluster: materialized {len(manifest.done_ids())}/"
          f"{len(manifest.shards)} shards, {done:,} edges in {dt:.1f}s "
          f"({done / max(dt, 1e-9):,.0f} edges/s) across "
          f"{args.num_workers} worker(s), {len(rounds)} round(s), "
          f"{sum(r['deaths'] for r in rounds)} death(s)",
          file=sys.stderr)
    print("cluster report: " + json.dumps(coord.report), file=sys.stderr)
    if args.trace is not None:
        print(f"traces: {args.out}/trace.w*.jsonl (python -m "
              f"repro_torch.scripts.report_run trace.w0.jsonl "
              f"trace.w1.jsonl ... for the merged stall report)",
              file=sys.stderr)
    if args.verify or args.verify_deep:
        problems = ShardedGraphDataset(args.out).verify(deep=True)
        if problems:
            print("VERIFY FAILED:", *problems, sep="\n  ",
                  file=sys.stderr)
            return 1
        print("verify: ok (deep, streamed crc)", file=sys.stderr)
    return 0


def main(argv=None, kill_after=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_mutually_exclusive_group()
    src.add_argument("--fit", default="demo",
                     help="'demo' or a KroneckerFit JSON (structure only)")
    src.add_argument("--asset", default=None, metavar="NPZ",
                     help="a saved fit (repro_torch.convert.save_state) "
                          "whose GAN features and aligner ride along")
    ap.add_argument("--edges", default=None,
                    help="total edge count E, e.g. 1e7 (overrides fit.E)")
    ap.add_argument("--scale-nodes", type=int, default=1,
                    help="node factor per partite (a power of two); edges "
                         "scale by its square (Eq. 22)")
    ap.add_argument("--shard-edges", default="1e6",
                    help="max edges per shard (memory bound), e.g. 1e6")
    ap.add_argument("--out", required=True, help="output dataset directory")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--k-pref", type=int, default=None,
                    help="prefix levels (default: auto from shard size)")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="App. 9 per-level θ-noise amplitude")
    ap.add_argument("--mode", choices=("chunks", "device_steps"),
                    default="chunks")
    ap.add_argument("--backend", default=None,
                    choices=("auto", "reference", "cuda_bits", "cuda_prng"),
                    help="edge-sampler backend (repro_torch.core.sampler): "
                         "'reference' = plain torch (the JAX package's "
                         "'xla' stream), 'cuda_bits' = threefry words in "
                         "memory + the bits kernel, 'cuda_prng' = the "
                         "in-register kernel (both the 'pallas_bits' "
                         "stream; on the CPU their plain versions). "
                         "Default/auto picks by device; the stream is "
                         "recorded in the manifest and validated on "
                         "--resume")
    ap.add_argument("--id-dtype", default=None, choices=("int32", "int64"),
                    help="node id width (default: auto from the fit — "
                         "int32 up to 2^31 ids, int64 up to 2^62)")
    ap.add_argument("--device", default="cuda",
                    help="where structure (and, with --asset, features) "
                         "are generated: 'cuda' (default) or 'cpu'")
    ap.add_argument("--workers", type=int, default=1,
                    help="worker queues in the plan (see --worker)")
    ap.add_argument("--worker", type=int, default=None,
                    help="only materialize this worker's shard queue")
    ap.add_argument("--num-workers", type=int, default=None,
                    help="multi-PROCESS generation: spawn this many "
                         "worker processes, each running one stripe of "
                         "the plan, and merge their journals into the "
                         "one manifest (repro_torch.distributed.cluster). "
                         "Output is byte-identical to the single-process "
                         "run. With --worker-id, run one stripe instead "
                         "of spawning")
    ap.add_argument("--worker-id", type=int, default=None,
                    help="run ONE stripe of an existing plan as this "
                         "worker (0..K-1 of --num-workers K): appends "
                         "completions to journal.w{k}.jsonl and never "
                         "rewrites manifest.json — what the cluster "
                         "coordinator spawns")
    ap.add_argument("--max-shards", type=int, default=None,
                    help="stop after N shards (incremental progress)")
    ap.add_argument("--resume", action="store_true",
                    help="continue an interrupted job in --out")
    ap.add_argument("--pipeline-depth", type=int, default=2,
                    help="shards queued per executor stage: 0 = serial "
                         "loop, >=1 overlaps struct sampling with the "
                         "feature stage and writer flush (output is "
                         "byte-identical either way). Default 2")
    ap.add_argument("--host-workers", type=int, default=1,
                    help="threads in the executor's feature stage")
    ap.add_argument("--fused", action="store_true",
                    help="draw each shard's feature rows on the card in "
                         "its struct stage. "
                         "Byte-identical to the staged path; recorded as "
                         "provenance, never validated on --resume")
    ap.add_argument("--serial", action="store_true",
                    help="fully serial generation: pipeline depth 0 plus "
                         "no chunk double buffering")
    ap.add_argument("--verify", action="store_true",
                    help="deep-verify after generation: re-CRC every "
                         "column in streamed blocks")
    ap.add_argument("--verify-deep", action="store_true",
                    help="alias of --verify")
    ap.add_argument("--trace", nargs="?", const="auto", default=None,
                    metavar="PATH",
                    help="record a span event log (crash-safe JSONL) of "
                         "the run; with no PATH it lands next to the "
                         "dataset manifest as OUT/trace.jsonl")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the run's counters/gauges/histograms + "
                         "stage timings as a versioned JSON envelope")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="additionally run torch.profiler over the run "
                         "and write its Chrome trace into DIR")
    args = ap.parse_args(argv)
    if args.worker_id is not None and args.num_workers is None:
        ap.error("--worker-id needs --num-workers (the stripe count "
                 "the plan was made for)")
    if args.num_workers is not None:
        if args.num_workers < 1:
            ap.error(f"--num-workers {args.num_workers} < 1")
        if args.workers != 1 or args.worker is not None:
            ap.error("--num-workers (multi-process) and "
                     "--workers/--worker (in-process striping) are "
                     "mutually exclusive")
        if args.worker_id is not None \
                and not 0 <= args.worker_id < args.num_workers:
            ap.error(f"--worker-id {args.worker_id} outside "
                     f"0..{args.num_workers - 1}")

    import numpy as np

    from repro_torch.datastream import DatasetJob, ShardedGraphDataset
    from repro_torch.kernels import rmat_sample as rs
    from repro_torch.obs import (JsonlSink, MetricsRegistry, Tracer,
                                 profile, write_bench)
    from repro_torch.utils import parse_count

    coordinator = args.num_workers is not None and args.worker_id is None
    if args.asset:
        fit, features = (plan_asset if coordinator else build_asset)(args)
    else:
        fit, features = build_fit(args), None
    tracer = Tracer()
    metrics = MetricsRegistry()
    trace_path = None
    if args.trace is not None and not coordinator:
        # the coordinator generates nothing — its workers each record
        # their own namespaced trace (trace.w{k}.jsonl)
        trace_path = (os.path.join(args.out, "trace.jsonl")
                      if args.trace == "auto" else args.trace)
        if args.worker_id is not None:
            trace_path = worker_path(trace_path, args.worker_id)
        os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
        tracer.add_sink(JsonlSink(trace_path))
    try:
        job = DatasetJob(fit, args.out,
                         shard_edges=parse_count(args.shard_edges),
                         seed=args.seed, k_pref=args.k_pref,
                         num_workers=(args.num_workers
                                      if args.num_workers is not None
                                      else args.workers),
                         double_buffered=not args.serial, mode=args.mode,
                         features=features, backend=args.backend,
                         id_dtype=args.id_dtype,
                         pipeline_depth=(0 if args.serial
                                         else args.pipeline_depth),
                         host_workers=args.host_workers, fused=args.fused,
                         tracer=tracer, metrics=metrics, device=args.device)
    except (KeyError, ValueError) as e:
        raise SystemExit(f"error: {e}")
    print(f"plan: E={fit.E:,} edges, 2^{fit.n}×2^{fit.m} ids "
          f"({np.dtype(job.dtype).name}), k_pref={job.k_pref}, "
          f"{len(job.scheduler.chunks)} chunks in "
          f"{len(job.scheduler.shards)} shards "
          f"(max {job.scheduler.max_shard_edges:,} edges/shard), "
          f"mode={args.mode}, backend={job.sampler or job.mode} "
          f"(stream {job.backend}), device={job.device}, "
          f"features={'yes' if features is not None else 'no'}, "
          f"pipeline_depth={job.pipeline_depth}, "
          f"host_workers={job.host_workers}, fused={job.fused}",
          file=sys.stderr)
    if coordinator:
        tracer.close()
        return run_cluster(args, job, kill_after=kill_after)
    rs.reset_launches()
    profile_dir = args.torch_profile
    if profile_dir and args.worker_id is not None:
        profile_dir = worker_path(profile_dir, args.worker_id)
    t0 = time.time()
    try:
        with profile.trace(profile_dir):
            if args.worker_id is not None:
                manifest = job.run_worker(args.worker_id,
                                          max_shards=args.max_shards)
            else:
                manifest = job.run(resume=args.resume,
                                   max_shards=args.max_shards,
                                   worker=args.worker)
    except FileExistsError:
        raise SystemExit(f"error: {args.out} already holds a dataset — "
                         "pass --resume to continue it, or choose a "
                         "different --out")
    except (FileNotFoundError, ValueError) as e:
        raise SystemExit(f"error: {e}")
    finally:
        tracer.close()
    dt = time.time() - t0
    done = manifest.done_edges()
    t = job.timings
    print(f"materialized {len(manifest.done_ids())}/"
          f"{len(manifest.shards)} shards, {done:,} edges "
          f"in {dt:.1f}s ({done / max(dt, 1e-9):,.0f} edges/s); kernel "
          f"launches {dict(rs.LAUNCHES)}", file=sys.stderr)
    print(f"stages: struct {t['gen_struct_s']:.1f}s, "
          f"feat {t['gen_feat_s']:.1f}s, align {t['gen_align_s']:.1f}s, "
          f"write {t['write_s']:.1f}s busy over {t['wall_s']:.1f}s wall "
          f"(overlap {t['overlap']:.2f}x, stalled {t['stall_s']:.1f}s)",
          file=sys.stderr)
    if trace_path:
        print(f"trace: {trace_path}", file=sys.stderr)
    if args.metrics_out:
        metrics_path = (worker_path(args.metrics_out, args.worker_id)
                        if args.worker_id is not None
                        else args.metrics_out)
        write_bench("generate_dataset",
                    {"timings": t, "launches": dict(rs.LAUNCHES),
                     "registry": metrics.snapshot()}, metrics_path)
        print(f"metrics: {metrics_path}", file=sys.stderr)
    if args.worker_id is not None:
        # one stripe of a larger run: completeness, verification and the
        # manifest compaction belong to the coordinator
        return 0
    if manifest.is_complete():
        ds = ShardedGraphDataset(args.out)
        assert ds.total_edges == fit.E
        if args.verify or args.verify_deep:
            problems = ds.verify(deep=True)
            if problems:
                print("VERIFY FAILED:", *problems, sep="\n  ",
                      file=sys.stderr)
                return 1
            print("verify: ok (deep, streamed crc)", file=sys.stderr)
    elif not args.max_shards and args.worker is None:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
