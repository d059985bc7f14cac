"""Paper §8.4: pre-train a GNN on a generated graph, fine-tune on the
original — synthetic pre-training should not hurt (and usually helps) vs
training from scratch.

    python -m repro_torch.examples.pretrain_finetune_gnn [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data.reference import cora_like
from repro_torch.models.gnn import (GNNConfig, make_node_classifier,
                                    train_node_classifier)


def main(device="cuda") -> dict:
    g, cont, cat = cora_like(n=1024, n_edges=6000)
    labels = cat[:, 0]
    cfg = GNNConfig(kind="gcn", n_classes=int(labels.max()) + 1)

    # scratch baseline
    _, acc_scratch, _ = train_node_classifier(g, cont, labels, cfg,
                                              epochs=60, device=device)

    # generate a synthetic twin (structure + node features + alignment)
    pipe = SyntheticGraphPipeline(struct="kronecker", features="kde",
                                  aligner="xgboost", feature_kind="node",
                                  gan_steps=0, device=device)
    pipe.fit(g, cont, cat)
    gs, cs, ks = pipe.generate(seed=0)
    syn_labels = ks[:, 0].cpu().numpy()

    # pre-train on synthetic, then fine-tune on the original graph
    model, acc_syn, _ = train_node_classifier(
        gs, cs.cpu().numpy(), syn_labels, cfg, epochs=40, device=device)
    # fine-tune: the pre-trained weights, fresh momentum buffers
    train_step, predict = make_node_classifier(cfg, g, device)
    rng = np.random.default_rng(0)
    n = g.n_nodes
    feats = torch.as_tensor(np.asarray(cont, np.float32)).to(device)
    lab = torch.as_tensor(np.asarray(labels, np.int64)).to(device)
    mask = np.zeros(n, np.float32)
    idx = rng.permutation(n)
    mask[idx[: int(n * 0.6)]] = 1.0
    test_idx = idx[int(n * 0.6):]
    opt = [torch.zeros_like(p) for p in model.parameters()]
    mask_t = torch.from_numpy(mask).to(device)
    for _ in range(40):
        train_step(model, opt, feats, lab, mask_t)
    pred = predict(model, feats).cpu().numpy()
    acc_ft = float((pred[test_idx] == labels[test_idx]).mean())

    print(f"scratch accuracy:            {acc_scratch:.4f}")
    print(f"synthetic-only accuracy:     {acc_syn:.4f}")
    print(f"pretrain->finetune accuracy: {acc_ft:.4f}")
    print("note: per-node alignment preserves degree<->label couplings but "
          "not pairwise homophily (label-edge couplings) — the paper's own "
          "§8.5 caveat: decoupled structure/feature generation limits tasks "
          "whose signal is intrinsically pairwise.")
    return {"scratch": acc_scratch, "synthetic": acc_syn,
            "finetune": acc_ft}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    main(ap.parse_args().device)
