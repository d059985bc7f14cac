"""Fit θ (and its provenance) from a materialized dataset — the inverse of
``generate_dataset``, closing the fit → generate → refit loop:

    python -m repro_torch.scripts.fit_dataset --dataset /data/ds \\
        --out /data/fit.json

reads the dataset manifest, streams every shard through the one-pass
accumulators of ``repro_torch.core.fit_engine`` (bit-pair MLE, degree
sketches, order-invariant row sample) and writes a deterministic fit
JSON: a ``KroneckerFit`` under ``"fit"`` plus the ``"provenance"`` block
(per-level bit-pair counts, sketch digests, candidate calibration
scores, sample identity, feature moments, the generator's manifest
settings).  The JSON is the JAX package's ``scripts/fit_dataset.py``
output byte for byte, and ``generate_dataset --fit`` takes it as it is.

Runs on the CUDA card unless ``--device cpu`` is given.  Peak memory is
bounded by ``--chunk-rows`` plus the fixed-size sketches, never by the
dataset.  ``--check-theta T`` exits non-zero when the fitted θ deviates
from the manifest's generator θ by more than ``T`` in any of (a, b, c,
d) — the round-trip check.
"""
from __future__ import annotations

import argparse
import os
import sys
import time


def generator_provenance(manifest) -> dict:
    """Which generation path produced the input dataset: ``backend`` names
    the edge stream, ``executor`` carries the byte-transparent knobs —
    provenance for reproducing the run, never validated."""
    return {"backend": manifest.backend, "mode": manifest.mode,
            "executor": manifest.executor}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dataset", required=True,
                    help="dataset directory (manifest.json inside)")
    ap.add_argument("--out", required=True, help="fit JSON output path")
    ap.add_argument("--chunk-rows", default="1<<20",
                    help="rows per fit chunk (the memory bound)")
    ap.add_argument("--sample-rows", default="100000",
                    help="row-sample size feeding feature moments / "
                         "provenance")
    ap.add_argument("--kmax", type=int, default=2048,
                    help="degree-sketch histogram bins (tail clipped)")
    ap.add_argument("--seed", type=int, default=0,
                    help="row-sample priority seed")
    ap.add_argument("--noise", type=float, default=0.0,
                    help="App. 9 θ-noise amplitude recorded on the fit")
    ap.add_argument("--no-calibrate", action="store_true",
                    help="skip the candidate calibration ladder (pure "
                         "MLE + Eq. 6 refinement)")
    ap.add_argument("--structure-only", action="store_true",
                    help="ignore feature columns (skip moments/sample "
                         "feature provenance)")
    ap.add_argument("--check-theta", type=float, default=None,
                    metavar="TOL",
                    help="exit 1 unless max |θ_fit − θ_manifest| <= TOL "
                         "(round-trip verification)")
    ap.add_argument("--device", default="cuda",
                    help="where the accumulators and the calibration "
                         "samples run: 'cuda' (default) or 'cpu'")
    ap.add_argument("--trace", nargs="?", const="auto", default=None,
                    metavar="PATH",
                    help="record a span event log (crash-safe JSONL) of "
                         "the fit pass; with no PATH it lands next to "
                         "--out as OUT.trace.jsonl")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write accumulate/fit timings as a versioned JSON "
                         "envelope")
    ap.add_argument("--torch-profile", default=None, metavar="DIR",
                    help="additionally run torch.profiler over the fit and "
                         "write its Chrome trace into DIR")
    args = ap.parse_args(argv)

    from repro_torch.core import fit_engine
    from repro_torch.datastream.fitsource import DatasetFitSource
    from repro_torch.obs import JsonlSink, Tracer, profile, write_bench
    from repro_torch.utils import parse_count

    tracer = Tracer()
    trace_path = None
    if args.trace is not None:
        trace_path = (args.out + ".trace.jsonl"
                      if args.trace == "auto" else args.trace)
        os.makedirs(os.path.dirname(trace_path) or ".", exist_ok=True)
        tracer.add_sink(JsonlSink(trace_path))

    cols = (("src", "dst") if args.structure_only
            else ("src", "dst", "cont", "cat"))
    try:
        source = DatasetFitSource(args.dataset,
                                  chunk_rows=parse_count(args.chunk_rows),
                                  columns=cols)
    except (FileNotFoundError, RuntimeError, ValueError) as e:
        raise SystemExit(f"error: {e}")
    man = source.ds.manifest
    print(f"fit plan: {source.total_rows:,} rows over "
          f"{len(source.ds)} shards, 2^{man.fit['n']}×2^{man.fit['m']} ids "
          f"({man.dtype}), chunk_rows={parse_count(args.chunk_rows):,}, "
          f"device={args.device}", file=sys.stderr)
    t0 = time.time()
    try:
        with profile.trace(args.torch_profile):
            stats = fit_engine.accumulate(
                source, sample_rows=parse_count(args.sample_rows),
                seed=args.seed, kmax=args.kmax, tracer=tracer,
                device=args.device)
            t_acc = time.time() - t0
            t0 = time.time()
            with tracer.span("fit.theta"):
                fit, prov = fit_engine.fit_structure_streamed(
                    stats, noise=args.noise,
                    calibrate=not args.no_calibrate, device=args.device)
            t_fit = time.time() - t0
    finally:
        tracer.close()
    prov["generator"] = generator_provenance(man)
    text = fit_engine.fit_to_json(fit, prov)
    tmp = args.out + ".tmp"
    with open(tmp, "w") as f:
        f.write(text)
    os.replace(tmp, args.out)

    rate = stats.rows / max(t_acc, 1e-9)
    print(f"accumulated {stats.rows:,} rows in {t_acc:.3f}s "
          f"({rate:,.0f} rows/s; read {tracer.total('fit.read'):.3f}s, "
          f"update {tracer.total('fit.update'):.3f}s, finalize "
          f"{tracer.total('fit.finalize'):.3f}s), θ-fit in {t_fit:.3f}s "
          f"(chosen: {prov.get('chosen')})", file=sys.stderr)
    print(f"θ = ({fit.a:.4f}, {fit.b:.4f}, {fit.c:.4f}, {fit.d:.4f})  "
          f"MLE = ({', '.join(f'{x:.4f}' for x in prov['theta_mle'])})",
          file=sys.stderr)

    gen_fit = man.fit
    err = max(abs(fit.a - gen_fit["a"]), abs(fit.b - gen_fit["b"]),
              abs(fit.c - gen_fit["c"]), abs(fit.d - gen_fit["d"]))
    print(f"round-trip: max |θ_fit − θ_gen| = {err:.4f}", file=sys.stderr)
    if trace_path:
        print(f"trace: {trace_path}", file=sys.stderr)
    if args.metrics_out:
        timings = {"accumulate_s": t_acc, "theta_fit_s": t_fit}
        for span in ("read", "update", "finalize"):
            timings[f"fit_{span}_s"] = tracer.total(f"fit.{span}")
        write_bench("fit_dataset",
                    {"timings": timings, "rows": stats.rows,
                     "n_chunks": stats.n_chunks, "theta_err": err,
                     "device": args.device},
                    args.metrics_out)
        print(f"metrics: {args.metrics_out}", file=sys.stderr)
    if args.check_theta is not None and err > args.check_theta:
        print(f"CHECK FAILED: {err:.4f} > tolerance {args.check_theta}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
