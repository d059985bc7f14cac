"""Quickstart: fit the synthetic-graph pipeline on a reference dataset,
generate at 1× and 2× scale, and print the paper's quality metrics.

    python -m repro_torch.examples.quickstart [--device cpu]

On the card the structure is drawn by the in-register R-MAT kernel (the
auto backend).
"""
from __future__ import annotations

import argparse

from repro_torch.core.metrics import evaluate_all
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data.reference import tabformer_like


def main(device="cuda") -> dict:
    # 1. "Proprietary" input graph (Tabformer-like reference stand-in)
    g, cont, cat = tabformer_like(n_src=1024, n_dst=128, n_edges=8000)
    print(f"input graph: {g.n_src}x{g.n_dst} bipartite, E={g.n_edges}, "
          f"{cont.shape[1]} continuous + {cat.shape[1]} categorical features")

    # 2. Fit the three components (structure / features / aligner)
    pipe = SyntheticGraphPipeline(struct="kronecker", features="gan",
                                  aligner="xgboost", noise=0.03,
                                  gan_steps=200, device=device)
    pipe.fit(g, cont, cat)
    print(f"fitted θ_S = [[{pipe.struct.a:.3f}, {pipe.struct.b:.3f}], "
          f"[{pipe.struct.c:.3f}, {pipe.struct.d:.3f}]]")

    # 3. Generate at 1× and 2× scale (Eq. 22: nodes ×2, edges ×4)
    scores = {}
    for scale in (1, 2):
        gs, cs, ks = pipe.generate(seed=0, scale_nodes=scale)
        m = evaluate_all(g, cont, cat, gs, cs, ks, device=device)
        scores[scale] = m
        print(f"scale {scale}x: nodes={gs.n_nodes} edges={gs.n_edges} "
              f"degree_dist={m['degree_dist']:.3f} "
              f"feature_corr={m['feature_corr']:.3f} "
              f"degree_feat_js={m['degree_feat_dist']:.3f}")

    print("timings:", pipe.timings)
    return {"pipe": pipe, "scores": scores}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
