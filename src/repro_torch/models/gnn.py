"""GCN / GAT node classifiers on COO edge lists (paper §8.1 throughput and
§8.4 pretrain→finetune experiments), the JAX package's ``models/gnn.py``
on torch autograd.

Messages run over the symmetrised edges with one self-loop a node
(``SymEdges``).  The reference's ``segment_sum`` is ``segment_reduce``
over the edges sorted by tail once (a stable sort): its sums come out the
same from run to run on the card, where ``index_add_`` adds with atomics
in no fixed order, it carries the gradient, and one path serves the CPU
and the card.  ``segment_max`` is ``scatter_reduce("amax")``; every node
has its self-loop, so no node's maximum is empty.  The update is the
reference's by hand, m = 0.9·o + 0.1·g from o = 0, then p −= lr·m
(``torch.optim.SGD(momentum=0.9, dampening=0.9)`` would seed its buffer
with g on the first step).  Every message tensor holds E_sym × hidden
float32, as in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import random as trandom
from repro_torch.graph.ops import Graph


@dataclasses.dataclass(frozen=True)
class GNNConfig:
    kind: str = "gcn"          # gcn | gat
    hidden: int = 128
    n_layers: int = 2
    n_classes: int = 7
    lr: float = 0.01


class SymEdges:
    """``g``'s edges both ways plus a self-loop on every node, on
    ``device``, sorted by tail (stable): ``heads``/``tails`` int64,
    ``lengths`` the edges into each node, ``deg`` the float32 edge count
    out of each node (GCN's degree)."""

    def __init__(self, g: Graph, device="cuda"):
        src = g.src.to(device=device, dtype=torch.int64)
        dst = g.dst.to(device=device, dtype=torch.int64) \
            + (g.n_src if g.bipartite else 0)
        n = self.n = g.n_nodes
        loops = torch.arange(n, device=src.device)
        heads = torch.cat([src, dst, loops])
        tails = torch.cat([dst, src, loops])
        self.deg = torch.bincount(heads, minlength=n).to(torch.float32)
        order = torch.sort(tails, stable=True).indices
        self.heads, self.tails = heads[order], tails[order]
        self.lengths = torch.bincount(tails, minlength=n)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Σ over the edges into each node of the rows of ``x`` (one row
        per sorted edge)."""
        return torch.segment_reduce(x, "sum", lengths=self.lengths, axis=0,
                                    unsafe=True)


class _Layer(nn.Module):
    def __init__(self, p: Dict[str, torch.Tensor]):
        super().__init__()
        for name, t in p.items():
            self.register_parameter(name, nn.Parameter(t))


class GNN(nn.Module):
    """Layers of parameters as in the reference's list of dicts: ``w``
    (d_in, d_out), ``b``; GAT's also ``att_src``, ``att_dst`` (d_out,)."""

    def __init__(self, params: List[Dict[str, torch.Tensor]]):
        super().__init__()
        self.layers = nn.ModuleList(_Layer(p) for p in params)


class GCN(GNN):
    def forward(self, x: torch.Tensor, edges: SymEdges) -> torch.Tensor:
        norm = torch.rsqrt(torch.clamp_min(edges.deg, 1.0))
        hd, tl = edges.heads, edges.tails
        h = x
        for i, p in enumerate(self.layers):
            h = h @ p.w + p.b
            h = edges.sum(h[hd] * norm[hd, None] * norm[tl, None])
            if i < len(self.layers) - 1:
                h = torch.relu(h)
        return h


class GAT(GNN):
    def forward(self, x: torch.Tensor, edges: SymEdges) -> torch.Tensor:
        hd, tl = edges.heads, edges.tails
        h = x
        for i, p in enumerate(self.layers):
            h = h @ p.w + p.b
            e = F.leaky_relu((h @ p.att_src)[hd] + (h @ p.att_dst)[tl], 0.2)
            # softmax over the edges into each tail
            emax = torch.full((edges.n,), -torch.inf, dtype=e.dtype,
                              device=e.device).scatter_reduce(
                0, tl, e, "amax", include_self=False)
            w = torch.exp(e - emax[tl])
            alpha = w / torch.clamp_min(edges.sum(w)[tl], 1e-9)
            h = edges.sum(h[hd] * alpha[:, None])
            if i < len(self.layers) - 1:
                h = F.elu(h)
        return h


_KINDS = {"gcn": GCN, "gat": GAT}


def gnn_from_params(cfg: GNNConfig, params: List[Dict[str, torch.Tensor]]
                    ) -> GNN:
    if cfg.kind not in _KINDS:
        raise ValueError(f"unknown GNN kind {cfg.kind!r}; the port has "
                         f"{sorted(_KINDS)}")
    return _KINDS[cfg.kind](params)


def init_gnn(key: torch.Tensor, cfg: GNNConfig, d_in: int,
             device="cuda") -> GNN:
    """The reference's initialisation from the port's threefry normals:
    ``w = normal(keys[i]) / sqrt(d_in)``, ``b = 0``; GAT's attention
    vectors are ``normal(keys[i]) * 0.1`` from the same ``keys[i]`` as
    ``w``, so ``att_src == att_dst`` as in the reference (ROADMAP C9)."""
    dims = [d_in] + [cfg.hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    keys = trandom.split(key, len(dims))
    params = []
    for i in range(len(dims) - 1):
        scale = torch.tensor(np.sqrt(dims[i]), dtype=torch.float32,
                             device=device)
        p = {"w": trandom.normal(keys[i], (dims[i], dims[i + 1]), device)
             / scale,
             "b": torch.zeros(dims[i + 1], device=device)}
        if cfg.kind == "gat":
            p["att_src"] = trandom.normal(keys[i], (dims[i + 1],),
                                          device) * 0.1
            p["att_dst"] = trandom.normal(keys[i], (dims[i + 1],),
                                          device) * 0.1
        params.append(p)
    return gnn_from_params(cfg, params)


def make_node_classifier(cfg: GNNConfig, g: Graph, device="cuda"):
    """``(train_step, predict)`` over ``g``'s symmetrised edges on
    ``device``.  ``train_step(model, opt, x, labels, mask)`` takes one
    momentum step in place (``opt``: one zero-initialised buffer per
    parameter, in ``model.parameters()`` order) and returns the loss
    before it; ``predict(model, x)`` the argmax classes."""
    edges = SymEdges(g, device)

    def loss_fn(model, x, labels, mask):
        lp = torch.log_softmax(model(x, edges), -1)
        ll = lp.gather(-1, labels[:, None])[:, 0]
        return -torch.sum(ll * mask) / torch.clamp_min(mask.sum(), 1.0)

    def train_step(model: GNN, opt: List[torch.Tensor], x, labels, mask
                   ) -> torch.Tensor:
        params = list(model.parameters())
        loss = loss_fn(model, x, labels, mask)
        grads = torch.autograd.grad(loss, params)
        with torch.no_grad():
            for p, o, g_ in zip(params, opt, grads):
                o.copy_(0.9 * o + 0.1 * g_)
                p.sub_(cfg.lr * o)
        return loss.detach()

    def predict(model: GNN, x) -> torch.Tensor:
        with torch.no_grad():
            return torch.argmax(model(x, edges), -1)

    return train_step, predict


def train_node_classifier(g: Graph, feats: np.ndarray, labels: np.ndarray,
                          cfg: GNNConfig, epochs: int = 50, seed: int = 0,
                          train_frac: float = 0.6, device="cuda"
                          ) -> Tuple[GNN, float, np.ndarray]:
    """Train on a random ``train_frac`` of the labelled nodes (numpy's
    ``default_rng(seed)`` on the host, as in the reference) and score the
    rest, from ``init_gnn(PRNGKey(seed))``.  Returns the model, the test
    accuracy and the loss of every epoch (the reference's loop drops
    them)."""
    rng = np.random.default_rng(seed)
    n = g.n_nodes
    feats = torch.as_tensor(np.asarray(feats, np.float32)).to(device)
    if feats.shape[0] < n:
        feats = F.pad(feats, (0, 0, 0, n - feats.shape[0]))
    labels_t = torch.from_numpy(np.pad(labels, (0, max(0, n - len(labels)))
                                       ).astype(np.int64)).to(device)
    mask = np.zeros(n, np.float32)
    idx = rng.permutation(len(labels))
    mask[idx[: int(len(labels) * train_frac)]] = 1.0
    test_idx = idx[int(len(labels) * train_frac):]
    train_step, predict = make_node_classifier(cfg, g, device)
    model = init_gnn(trandom.PRNGKey(seed), cfg, feats.shape[1], device)
    opt = [torch.zeros_like(p) for p in model.parameters()]
    mask_t = torch.from_numpy(mask).to(device)
    losses = [train_step(model, opt, feats, labels_t, mask_t)
              for _ in range(epochs)]
    pred = predict(model, feats).cpu().numpy()
    acc = float((pred[test_idx] == labels[test_idx]).mean())
    return model, acc, torch.stack(losses).cpu().numpy() if losses \
        else np.zeros(0, np.float32)
