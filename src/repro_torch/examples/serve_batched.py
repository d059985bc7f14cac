"""Serve a small model with continuous batching: mixed-length prompts share
one fixed-shape decode computation.

    python -m repro_torch.examples.serve_batched [--device cpu]

``tinyllama-1.1b`` cut to the example's smoke width (weights from
``init_params(PRNGKey(0))``), 10 requests, 4 slots.  The engine's cache
path is the einsum path, so it launches no kernel of the port.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.serving.engine import Request, ServingEngine


def config():
    """The example's model: the JAX example's smoke-sized tinyllama."""
    return get_config("tinyllama-1.1b").smoke().replace(
        vocab=512, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256)


def requests(cfg):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(1, cfg.vocab, size=rng.integers(3, 24)),
                    max_new=16) for i in range(10)]


def main(device="cuda", params=None, dtype=None) -> dict:
    """Serve the 10 requests; ``params`` replaces the seeded weights
    (e.g. a checkpoint carried across by ``convert``), ``dtype`` the
    model's bfloat16."""
    cfg = config() if dtype is None else config().replace(dtype=dtype)
    model = Model(cfg, device=device)
    if params is None:
        params = model.init_params(trandom.PRNGKey(0))
    engine = ServingEngine(model, params, max_batch=4, max_len=128)
    reqs = requests(cfg)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    t0 = time.time()
    out = engine.run(reqs)
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in out.values())
    for rid in sorted(out)[:4]:
        print(f"req {rid}: {out[rid]}")
    print(f"{len(reqs)} requests, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens / dt:.1f} tok/s, continuous batching over "
          f"{engine.B} slots)")
    return {"out": out, "seconds": dt, "tokens": total_tokens}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
