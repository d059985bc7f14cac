#!/usr/bin/env python3
"""Trace the PyTorch port's train step of full-width tinyllama-1.1b on one
NVIDIA card.

    python3 scripts/profile_torch_train.py [--steps 3] [--trace PATH]

The model and batch of ``chip_smoke.py`` phase 18(a): 22 layers, bf16,
two microbatches of 4 × 2048 tokens (``SyntheticTokens`` here), einsum
attention, remat ``"nothing"``, TF32 off.  Prints the first microbatch's
forward and backward on a cold process and again warm, ``--steps`` whole
steps' host wall (each ends on reading the loss), then one step under
``torch.profiler``: its device time by kernel class (float32 and bf16
matrix products, softmax, copies, other elementwise work), the top
kernels, kernel launches, the device's busy time and idle share.  The
Chrome trace goes to ``--trace``.  Exits non-zero without a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


def kernel_class(name: str) -> str:
    low = name.lower()
    if "memcpy" in low or "memset" in low:
        return "copies"
    if any(k in low for k in ("gemm", "nvjet", "xmma", "cutlass")):
        return ("float32 products" if "f32f32_f32f32" in low
                else "bf16 products")
    if "softmax" in low:
        return "softmax"
    return "other elementwise"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=str(ROOT / "chiprun_out"
                                           / "train_step.trace.json"))
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import random as tr
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import SyntheticTokens
    from repro_torch.models import Model
    from repro_torch.models.params import leaves
    from repro_torch.obs.metrics import gpu_line
    from repro_torch.training import optimizer as opt
    from repro_torch.training.steps import make_train_step

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("tinyllama-1.1b").replace(
        attn_impl="einsum", remat=True, remat_policy="nothing")
    model = Model(cfg, "cuda")
    params = model.init_params(tr.PRNGKey(0))
    state = opt.init_opt_state(params)
    data = SyntheticTokens(cfg.vocab, seed=0).batches(8, 2048)
    print(f"card: {gpu_line()}; torch {torch.__version__}")

    weights = leaves(params.tree())
    for w in weights:
        w.requires_grad_(True)
    b = next(data)
    mb = {k: torch.from_numpy(v[:4].copy()).cuda() for k, v in b.items()}
    for label in ("cold", "warm"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = model.loss(params, mb)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        torch.autograd.grad(loss, weights)
        torch.cuda.synchronize()
        print(f"first microbatch, {label}: forward {t1 - t0:.3f} s, "
              f"backward {time.perf_counter() - t1:.3f} s")
        del loss

    step = make_train_step(model, opt.OptConfig(warmup_steps=2,
                                                total_steps=10))
    for i in range(args.steps):
        t0 = time.perf_counter()
        params, state, m = step(params, state, next(data))
        float(m["loss"])
        print(f"step {i + 1}: {time.perf_counter() - t0:.3f} s")

    batch = next(data)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        params, state, m = step(params, state, batch)
        float(m["loss"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    Path(args.trace).parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(args.trace)

    events = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA]
    if not events:
        print("profiler saw no device operations: busy time, idle share "
              "and device time by kernel not measured")
        return 0
    by_class, by_name = defaultdict(float), defaultdict(float)
    for e in events:
        us = e.time_range.end - e.time_range.start
        by_class[kernel_class(e.name)] += us
        by_name[e.name] += us
    busy = busy_us([(e.time_range.start, e.time_range.end) for e in events])
    launches = sum(1 for e in prof.events()
                   if e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC",
                                 "cuLaunchKernel", "cuLaunchKernelEx"))
    total = sum(by_class.values())
    print(f"traced step: wall {wall:.3f} s, device busy {busy / 1e6:.3f} s, "
          f"idle share {1 - busy / 1e6 / wall:.4f}, {launches} kernel "
          f"launches, {len(events)} device operations")
    for cls, us in sorted(by_class.items(), key=lambda kv: -kv[1]):
        print(f"  {cls}: {us / 1e3:.1f} ms ({us / total:.3f})")
    print("top device operations (ms):")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:12]:
        print(f"  {us / 1e3:9.1f}  {name[:110]}")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f}"
          f" GB; trace: {args.trace}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
