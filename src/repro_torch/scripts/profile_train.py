"""Trace the PyTorch port's train step of one LM family at its published
widths on one NVIDIA card.

    PYTHONPATH=src python -m repro_torch.scripts.profile_train \
        --arch qwen3-moe-30b-a3b [--layers 2] [--steps 3] [--trace PATH]

The model and batch of ``chip_smoke.py`` phase 20(a): the config's
published widths, ``--layers`` deep (default the config's), bf16, einsum
attention, remat ``"nothing"``, TF32 off, the config's own microbatches
of B = 8 × S = 2048 positions (``SyntheticTokens`` here; the VLM 256
seeded normal patches + 1792 tokens, the encdec 1024 frames + 1024
tokens).  Prints the first microbatch's forward and backward on a cold
process and again warm, ``--steps`` whole steps' host wall (each ends on
reading the loss), then one step under ``torch.profiler``: its device
time by kernel class (float32 and bf16 matrix products, softmax, copies,
other elementwise work), the top kernels, kernel launches, the device's
busy time and idle share.  The Chrome trace goes to ``--trace``.  Exits
non-zero without a card.  (``scripts/profile_torch_train.py`` traces the
dense tinyllama-1.1b step the same way.)
"""
from __future__ import annotations

import argparse
import sys
import time
from collections import defaultdict
from pathlib import Path


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


def batches(cfg, B: int, S: int, tr, SyntheticTokens):
    """Endless batches of ``S`` positions: ``SyntheticTokens`` (the VLM's
    ``S − n_patches`` after its patches, the encdec's ``S / 2`` after its
    frames) and seeded normal float32 patches or frames on the card."""
    n = S
    if cfg.family == "vlm":
        n = S - cfg.vlm.n_patches
    if cfg.family == "encdec":
        n = S // 2
    it = SyntheticTokens(cfg.vocab, seed=0).batches(B, n)
    i = 0
    while True:
        b = dict(next(it))
        key = tr.PRNGKey(11 + i)
        if cfg.family == "vlm":
            b["patches"] = tr.normal(key, (B, cfg.vlm.n_patches,
                                           cfg.vlm.patch_dim), "cuda")
        if cfg.family == "encdec":
            b["frames"] = tr.normal(key, (B, S - n, cfg.d_model), "cuda")
        i += 1
        yield b


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--trace", default=str(Path("results") / "torch_profile"
                                           / "train_step.trace.json"))
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("profile_train: no CUDA card visible", file=sys.stderr)
        return 1
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
    cfg = get_config(args.arch).replace(
        attn_impl="einsum", remat=True, remat_policy="nothing")
    if args.layers is not None:
        cfg = cfg.replace(n_layers=args.layers)
    model = Model(cfg, "cuda")
    params = model.init_params(tr.PRNGKey(0))
    state = opt.init_opt_state(params)
    data = batches(cfg, 8, 2048, tr, SyntheticTokens)
    print(f"card: {gpu_line()}; torch {torch.__version__}; {cfg.name} "
          f"[{cfg.family}] L={cfg.n_layers} d={cfg.d_model}, "
          f"{cfg.microbatches} microbatches")

    weights = leaves(params.tree())
    for w in weights:
        w.requires_grad_(True)
    b = next(data)
    n = 8 // cfg.microbatches
    mb = {k: (torch.from_numpy(v[:n].copy()) if not torch.is_tensor(v)
              else v[:n]).cuda() for k, v in b.items()}
    for k in ("patches", "frames"):
        if k in mb:
            mb[k] = mb[k].to(params.tok.dtype)
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
