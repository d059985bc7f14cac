#!/usr/bin/env python3
"""Trace GAN feature blocks of the PyTorch port on one NVIDIA card.

    python3 scripts/profile_torch_gan.py [--blocks 4] [--trace PATH]

Loads the committed fit (``src/repro_torch/assets/tabformer_like_fit.npz``)
on the card and draws ``--blocks`` feature blocks of the generator's
default size (65 536 rows, the block of ``generate(scale_nodes=64)``),
first without and then under ``torch.profiler``, each after a warm-up
block.  Prints per block: host wall time (untraced and traced), device
operations (kernels, copies, fills), kernel launches issued by the host,
host-device synchronisations, the device's busy time (the union of its
operations' intervals) and its idle share (1 − busy / traced wall).  The
Chrome trace goes to ``--trace``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--blocks", type=int, default=4)
    ap.add_argument("--trace", default=str(ROOT / "chiprun_out"
                                           / "gan_blocks.trace.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_gan: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import convert, random as tr

    torch.backends.cuda.matmul.allow_tf32 = False
    pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                       device="cuda")
    gan = pipe.features
    rows = gan.cfg.sample_batch
    draw = gan.block_draw(rows)
    key = tr.PRNGKey(0)

    def blocks(first: int) -> float:
        t0 = time.perf_counter()
        for i in range(first, first + args.blocks):
            draw(tr.fold_in(key, i))
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    draw(tr.fold_in(key, 0))
    torch.cuda.synchronize()
    plain_s = blocks(1)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        traced_s = blocks(1 + args.blocks)
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e for e in events if e.device_type == DeviceType.CPU]
    launches = sum(e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                              "cuLaunchKernel", "cuLaunchKernelEx")
                   for e in host)
    syncs = sum(e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize",
                           "cudaMemcpy") for e in host)
    nb = args.blocks
    print(f"card: {torch.cuda.get_device_name(0)}; torch "
          f"{torch.__version__}; {nb} blocks of {rows} rows")
    print(f"wall per block: untraced {plain_s / nb * 1e3:.3f} ms, traced "
          f"{traced_s / nb * 1e3:.3f} ms")
    if not device:
        print("profiler saw no device operations: busy time and idle share "
              "not measured")
    else:
        busy = busy_us((e.time_range.start, e.time_range.end)
                       for e in device) / 1e6
        print(f"per block: {len(device) / nb:.1f} device operations, "
              f"{launches / nb:.1f} kernel launches, {syncs / nb:.1f} "
              f"host-device syncs, device busy {busy / nb * 1e3:.3f} ms; "
              f"device idle share {1 - busy / traced_s:.4f} of the traced "
              f"wall")
        by_name = {}
        for e in device:
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
        print("top device operations (count, total us):")
        for name, (n, t) in sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1])[:10]:
            print(f"  {n:6d} {t:12.1f}  {name[:100]}")
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)
    print(f"trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
