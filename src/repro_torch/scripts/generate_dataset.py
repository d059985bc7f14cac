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


def main(argv=None) -> int:
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

    import numpy as np

    from repro_torch.datastream import DatasetJob, ShardedGraphDataset
    from repro_torch.kernels import rmat_sample as rs
    from repro_torch.obs import (JsonlSink, MetricsRegistry, Tracer,
                                 profile, write_bench)
    from repro_torch.utils import parse_count

    if args.asset:
        fit, features = build_asset(args)
    else:
        fit, features = build_fit(args), None
    tracer = Tracer()
    metrics = MetricsRegistry()
    trace_path = None
    if args.trace is not None:
        trace_path = (os.path.join(args.out, "trace.jsonl")
                      if args.trace == "auto" else args.trace)
        os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
        tracer.add_sink(JsonlSink(trace_path))
    try:
        job = DatasetJob(fit, args.out,
                         shard_edges=parse_count(args.shard_edges),
                         seed=args.seed, k_pref=args.k_pref,
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
    rs.reset_launches()
    t0 = time.time()
    try:
        with profile.trace(args.torch_profile):
            manifest = job.run(resume=args.resume,
                               max_shards=args.max_shards)
    except FileExistsError:
        raise SystemExit(f"error: {args.out} already holds a dataset — "
                         "pass --resume to continue it, or choose a "
                         "different --out")
    except ValueError as e:
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
        write_bench("generate_dataset",
                    {"timings": t, "launches": dict(rs.LAUNCHES),
                     "registry": metrics.snapshot()}, args.metrics_out)
        print(f"metrics: {args.metrics_out}", file=sys.stderr)
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
    elif not args.max_shards:
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
