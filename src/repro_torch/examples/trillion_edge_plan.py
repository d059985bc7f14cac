"""Trillion-edge generation plan (paper §4.5 / App. 10): the chunk
decomposition a run over many cards or worker processes executes, then a
miniature of it generated here, its chunks checked and its θ recovered.

    python -m repro_torch.examples.trillion_edge_plan [--device cpu]

The miniature goes through ``sample_graph_chunked`` with the auto backend:
the in-register R-MAT kernel on the card, the reference stream on the
CPU.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch import random as trandom
from repro_torch.core import rmat
from repro_torch.core.structure import KroneckerFit, estimate_ratios_mle

#: worker processes a run is striped over in the printout (8 cards × 8
#: processes each)
WORKERS = 64


def main(device="cuda") -> dict:
    # MAG240M-like target scaled to 1e12 edges (paper Table 3, 10x row)
    target = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=32, m=32,
                          E=int(1.0e12))
    k_pref = 5                                     # 4^5 = 1024 chunks
    plan = rmat.chunk_plan(target, k_pref)
    sizes = np.array([c.n_edges for c in plan])
    print(f"target: 2^{target.n} x 2^{target.m} nodes, E={target.E:.2e}")
    print(f"chunk plan: {len(plan)} chunks (prefix {k_pref} levels), "
          f"sizes min={sizes.min():.2e} median={np.median(sizes):.2e} "
          f"max={sizes.max():.2e}, sum={sizes.sum():.3e}")
    print(f"striped over {WORKERS} worker processes: "
          f"{len(plan) / WORKERS:.1f} chunks/worker, largest chunk "
          f"{sizes.max():.2e} edges (no collective: each chunk is a pure "
          f"function of its index)")

    # miniature: same θ, 2^14 nodes, 2^20 edges, 16 chunks
    mini = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=14, m=14,
                        E=1 << 20)
    src, dst = rmat.sample_graph_chunked(trandom.PRNGKey(0), mini,
                                         k_pref=2, backend="auto",
                                         device=device)
    src, dst = src.cpu().numpy(), dst.cpu().numpy()
    est = estimate_ratios_mle(src, dst, mini.n, mini.m)
    quadrants = np.bincount(src >> (mini.n - 1), minlength=2)
    print(f"miniature: E={len(src):,}; recovered θ = {np.round(est, 3)} "
          f"(target [0.45 0.22 0.20 0.13])")
    print("edges per src-prefix quadrant:", quadrants)
    return {"sizes": sizes, "src": src, "dst": dst, "theta": est,
            "quadrants": quadrants}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
