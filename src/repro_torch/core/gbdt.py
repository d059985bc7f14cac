"""Histogram gradient-boosted trees — the aligner's predictor R.

The paper uses XGBoost with lr=0.1, max_depth=5, 100 estimators,
alpha=10.  Fitting is the JAX package's numpy histogram-tree fit
(``_fit_tree``: squared loss, quantile bins, XGBoost's L1/L2 leaf
shrinkage ``w = -sign(G)·max(|G|-α, 0) / (H + λ)``), vectorized over the
features with every float sum taken in the reference's order, so the same
inputs give the same trees.  A fitted forest is packed onto its bin grid
(``_pack_binned``) and predicts on the device:

* ``E`` (f, max_e) float32 — per-feature sorted bin edges, +inf padded;
* ``code`` (T, S) int32 — ``feature * 2^15 + bin_of(threshold)`` per
  node, 32000 in the low bits for nodes that never go right;
* ``leaf_bot`` (T, 2^depth) float32 — bottom-level leaf values;
* ``base``, ``lr``, ``depth``.

Each feature column is quantized once to ``#{edges < x}`` and every tree
descends by integer compares.  Trees are summed in the reference's order,
``carry + lr * leaf`` tree by tree in float32, so scores agree with it to
float rounding only where the two frameworks round differently.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

#: rows per descent block: bounds the int64 index temporaries
_ROW_BLOCK = 1 << 24


@dataclasses.dataclass
class GBDTConfig:
    n_rounds: int = 100
    max_depth: int = 5
    lr: float = 0.1
    n_bins: int = 32
    alpha: float = 10.0       # L1 on leaf weights (paper's setting)
    lam: float = 1.0          # L2
    min_child: int = 4


class _Tree:
    """Dense complete-binary-tree arrays (size 2^(depth+1)-1)."""

    def __init__(self, depth: int):
        size = 2 ** (depth + 1) - 1
        self.feature = np.zeros(size, np.int32)
        self.threshold = np.zeros(size, np.float32)
        self.leaf = np.zeros(size, np.float32)
        self.is_leaf = np.ones(size, bool)


def _leaf_value(G, H, cfg):
    g = -G
    w = np.sign(g) * np.maximum(np.abs(g) - cfg.alpha, 0) / (H + cfg.lam)
    return w


def _bin_keys(X, bins, n_bins: int) -> np.ndarray:
    """(f, n) int64: feature ``j``'s bin id of each row on its grid, plus
    ``j * (n_bins + 1)``, so that the features' bins lie end to end."""
    n, f = X.shape
    keys = np.empty((f, n), np.int64)
    for j in range(f):
        keys[j] = (np.searchsorted(bins[j], X[:, j], side="right")
                   + j * (n_bins + 1))
    return keys


def _fit_tree(X, grad, cfg: GBDTConfig, bins, keys=None) -> _Tree:
    """One depth-wise histogram tree on host arrays: per node and feature,
    the best split over the bin grid by gain (first maximum, features in
    order), nodes with fewer than ``2 * min_child`` rows left as leaves.

    The reference's per-node, per-feature loop, vectorized without
    changing a float sum: each node keeps its rows in increasing order
    (what the reference's ``node_of == node`` mask selects), and one
    ``bincount`` over the features' bins laid end to end adds each bin's
    gradients in the order the reference's per-feature ``bincount`` does.
    ``keys`` is ``_bin_keys(X, bins, cfg.n_bins)``, passed by a caller
    that fits many trees on one grid."""
    n, f = X.shape
    tree = _Tree(cfg.max_depth)
    if keys is None:
        keys = _bin_keys(X, bins, cfg.n_bins)
    nb = cfg.n_bins + 1
    feats = np.arange(f)
    rows = {0: np.arange(n)}        # node -> its rows, in row order

    for depth in range(cfg.max_depth):
        for node in range(2 ** depth - 1, 2 ** (depth + 1) - 1):
            idx = rows.get(node)
            if idx is None or len(idx) < 2 * cfg.min_child:
                continue
            cnt = len(idx)
            g = grad[idx]
            k = np.take(keys, idx, axis=1).ravel()
            G, H = g.sum(), float(cnt)
            base = _gain(G, H, cfg)
            hist_g = np.bincount(k, weights=np.tile(g, f),
                                 minlength=f * nb).reshape(f, nb)
            hist_n = np.bincount(k, minlength=f * nb).reshape(f, nb)
            cg = np.cumsum(hist_g, axis=1)[:, :-1]
            cn = np.cumsum(hist_n, axis=1)[:, :-1]
            ok = (cn >= cfg.min_child) & (H - cn >= cfg.min_child)
            gain = (_gain(cg, cn, cfg) + _gain(G - cg, H - cn, cfg) - base)
            gain = np.where(ok, gain, -np.inf)
            b = np.argmax(gain, axis=1)
            top = gain[feats, b]
            j = int(np.argmax(top))
            if top[j] > 0.0:
                b = int(b[j])
                tree.is_leaf[node] = False
                tree.feature[node] = j
                thr = bins[j][b] if b < len(bins[j]) else np.inf
                tree.threshold[node] = thr
                go_right = X[idx, j] > thr
                del rows[node]
                rows[2 * node + 1] = idx[~go_right]
                rows[2 * node + 2] = idx[go_right]

    # leaf values for every node a sample can stop at
    for node, idx in rows.items():
        if len(idx):
            tree.leaf[node] = _leaf_value(grad[idx].sum(), float(len(idx)),
                                          cfg)
    return tree


def _gain(G, H, cfg):
    g1 = np.maximum(np.abs(G) - cfg.alpha, 0.0)
    return 0.5 * g1 * g1 / (H + cfg.lam)


def _predict_tree_np(tree: _Tree, X: np.ndarray) -> np.ndarray:
    idx = np.zeros(len(X), np.int32)
    for _ in range(16):
        leafy = tree.is_leaf[idx]
        if leafy.all():
            break
        f = tree.feature[idx]
        thr = tree.threshold[idx]
        go_right = X[np.arange(len(X)), f] > thr
        idx = np.where(leafy, idx, np.where(go_right, 2 * idx + 2, 2 * idx + 1))
    return tree.leaf[idx]


#: never-right marker for leaf / inf-threshold nodes: any bin id compares
#: ``<= _BIN_SENTINEL``, so the descent goes left
_BIN_SENTINEL = 32000


def _pack_binned(trees: List[_Tree], bins, depth: int) -> dict:
    """Snap a fitted forest onto its histogram-bin grid: host arrays
    ``{"E", "code", "leaf_bot"}`` as the module docstring lays them out.
    ``bin_of(thr)`` is the *last* edge index equal to the threshold, so
    ``bin(x) > bin_of(thr) ⟺ x > thr`` exactly in float32; early leaves
    are pushed down to all their bottom-level descendants.  Raises if the
    forest cannot be packed (no trees or features, too many features or
    bins, a threshold off the grid); a forest fitted here always packs."""
    T = len(trees)
    S = 2 ** (depth + 1) - 1
    f = len(bins)
    edges32 = [np.asarray(b, np.float32) for b in bins]
    max_e = max((len(e) for e in edges32), default=0)
    if T == 0 or f == 0 or f >= (1 << 16) or max_e >= _BIN_SENTINEL:
        raise ValueError(f"cannot pack a forest of {T} trees over {f} "
                         f"features with {max_e} bin edges")
    E = np.full((f, max(max_e, 1)), np.inf, np.float32)
    for j, e in enumerate(edges32):
        E[j, :len(e)] = e
    feat = np.stack([t.feature for t in trees]).astype(np.int32)
    thr = np.stack([t.threshold for t in trees]).astype(np.float32)
    leaf = np.stack([t.leaf for t in trees]).astype(np.float32)
    isl = np.stack([t.is_leaf for t in trees])
    n_int = 2 ** depth - 1
    thrb = np.full((T, S), _BIN_SENTINEL, np.int32)
    for t in range(T):
        for s in range(n_int):
            if isl[t, s] or not np.isfinite(thr[t, s]):
                continue
            j = feat[t, s]
            b = int(np.searchsorted(edges32[j], thr[t, s], side="right")) - 1
            if b < 0 or edges32[j][b] != thr[t, s]:
                raise ValueError(f"tree {t} node {s}: threshold "
                                 f"{thr[t, s]} is off its bin grid")
            thrb[t, s] = b
    leaf_d, isl_d = leaf.copy(), isl.copy()
    for s in range(n_int):
        upd = isl_d[:, s]
        for c in (2 * s + 1, 2 * s + 2):
            leaf_d[:, c] = np.where(upd, leaf_d[:, s], leaf_d[:, c])
            isl_d[:, c] = isl_d[:, c] | upd
    code = feat * (1 << 15) + thrb
    return {"E": E, "code": code, "leaf_bot": leaf_d[:, n_int:]}


def _unpack_trees(code, leaf_bot, E, depth: int) -> List[_Tree]:
    """The host trees a bin pack stands for: each internal node splits at
    its bin edge (``inf`` for the never-right marker), leaves only on the
    bottom level.  ``_predict_tree_np`` on them gives the packed forest's
    per-tree leaves exactly: a pushed-down early leaf is reached through
    any of its descendants, and ``x > edge`` is the pack's bin compare."""
    code = np.asarray(code, np.int64)
    leaf_bot = np.asarray(leaf_bot, np.float32)
    E = np.asarray(E, np.float32)
    n_int = 2 ** depth - 1
    feat = code[:, :n_int] >> 15
    b = code[:, :n_int] & 0x7FFF
    never = b == _BIN_SENTINEL
    thr = np.where(never, np.float32(np.inf),
                   E[feat, np.where(never, 0, b)])
    trees = []
    for t in range(len(code)):
        tree = _Tree(depth)
        tree.feature[:n_int] = feat[t]
        tree.threshold[:n_int] = thr[t]
        tree.is_leaf[:n_int] = False
        tree.leaf[n_int:] = leaf_bot[t]
        trees.append(tree)
    return trees


def _host32(X) -> np.ndarray:
    if isinstance(X, torch.Tensor):
        X = X.detach().cpu().numpy()
    return np.asarray(X, np.float32)


@dataclasses.dataclass
class PackedForest:
    E: torch.Tensor           # (f, max_e) float32
    code: torch.Tensor        # (T, S) or (C, T, S) int32
    leaf_bot: torch.Tensor    # (T, 2^depth) or (C, T, 2^depth) float32
    base: torch.Tensor        # () or (C,) float32
    lr: float
    depth: int

    @classmethod
    def from_arrays(cls, d, device) -> "PackedForest":
        def t(x, dt):
            return torch.as_tensor(np.array(x), dtype=dt, device=device)
        return cls(E=t(d["E"], torch.float32), code=t(d["code"], torch.int32),
                   leaf_bot=t(d["leaf_bot"], torch.float32),
                   base=t(d["base"], torch.float32), lr=float(d["lr"]),
                   depth=int(d["depth"]))


def _quantize(X: torch.Tensor, E: torch.Tensor) -> torch.Tensor:
    """(n, f) float32 → (n, f) int16 bin ids ``#{edges < x}`` =
    ``searchsorted(edges, x, side="left")``; the +inf padding of ``E``
    sorts last, so it never counts."""
    XbT = torch.searchsorted(E.contiguous(), X.T.contiguous(), side="left")
    return XbT.T.to(torch.int16).contiguous()


def _scan_descent(code: torch.Tensor, leaf_bot: torch.Tensor,
                  Xb: torch.Tensor, base: torch.Tensor, lr: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """One forest over quantized rows ``Xb`` (n, f): each tree descends
    ``depth`` levels by integer compares, then ``carry + lr * leaf``."""
    n, f = Xb.shape
    flat = Xb.reshape(-1).to(torch.int32)
    rowoff = torch.arange(n, dtype=torch.int64, device=Xb.device) * f
    total = base.to(torch.float32).expand(n).clone()
    for t in range(code.shape[0]):
        cd = code[t].to(torch.int64)
        idx = torch.zeros(n, dtype=torch.int64, device=Xb.device)
        for k in range(depth):
            c = cd[(1 << k) - 1 + idx]
            x = flat[rowoff + (c >> 15)]
            idx = 2 * idx + (x > (c & 0x7FFF))
        total = total + lr * leaf_bot[t][idx]
    return total


def _forest_scan(code, leaf_bot, X, E, base, lr, depth) -> torch.Tensor:
    """Single-output forest: quantize once, sum all trees."""
    Xb = _quantize(X, E)
    return _scan_descent(code, leaf_bot, Xb, base, lr, depth)


def _forest_scan_multi(code, leaf_bot, X, E, base, lr, depth
                       ) -> torch.Tensor:
    """(C, T, S) one-vs-rest forests → (n, C) scores over one
    quantization of X."""
    Xb = _quantize(X, E)
    return torch.stack([_scan_descent(code[c], leaf_bot[c], Xb, base[c], lr,
                                      depth)
                        for c in range(code.shape[0])], dim=1)


def _by_row_blocks(fn, X: torch.Tensor) -> torch.Tensor:
    """Per-row scores are independent of the block, so large inputs are
    scored in ``_ROW_BLOCK`` slices to bound the temporaries."""
    if len(X) <= _ROW_BLOCK:
        return fn(X)
    return torch.cat([fn(X[i:i + _ROW_BLOCK])
                      for i in range(0, len(X), _ROW_BLOCK)])


class GBDTRegressor:
    """Built unfitted from a config (then ``fit`` on host arrays), or
    fitted from a ``packed`` forest (``repro_torch.convert``).  The pack
    lives on ``device``."""

    def __init__(self, cfg: Optional[GBDTConfig] = None,
                 packed: Optional[PackedForest] = None, device="cuda"):
        self.cfg = cfg if cfg is not None else GBDTConfig()
        self.packed = packed
        self.device = torch.device(device) if packed is None \
            else packed.E.device
        self.trees: List[_Tree] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTRegressor":
        """Boost ``n_rounds`` trees on squared loss from ``base = mean(y)``
        over ``n_bins`` quantile bins per feature, then pack."""
        cfg = self.cfg
        X = np.asarray(X, np.float32)
        y = np.asarray(y, np.float32)
        self.base = float(y.mean()) if y.size else 0.0
        pred = np.full_like(y, self.base)
        self.bins = [np.quantile(X[:, j],
                                 np.linspace(0, 1, cfg.n_bins + 1)[1:-1])
                     for j in range(X.shape[1])]
        self.bins = [np.unique(b) for b in self.bins]
        self.trees = []
        keys = _bin_keys(X, self.bins, cfg.n_bins)
        for _ in range(cfg.n_rounds):
            grad = pred - y                       # squared loss
            tree = _fit_tree(X, grad, cfg, self.bins, keys)
            self.trees.append(tree)
            pred += cfg.lr * _predict_tree_np(tree, X)
        self.packed = PackedForest.from_arrays(
            dict(_pack_binned(self.trees, self.bins, cfg.max_depth),
                 base=np.float32(self.base), lr=np.float32(cfg.lr),
                 depth=cfg.max_depth), self.device)
        return self

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        pk = self.packed
        X = X.to(device=pk.E.device, dtype=torch.float32)
        lr = torch.tensor(pk.lr, dtype=torch.float32, device=X.device)
        return _by_row_blocks(
            lambda x: _forest_scan(pk.code, pk.leaf_bot, x, pk.E, pk.base,
                                   lr, pk.depth), X)

    def predict_np(self, X) -> np.ndarray:
        """The numpy reference on the host: ``base``, then ``lr * leaf``
        tree by tree in float32, over the fitted trees (or those of a
        carried pack)."""
        X = _host32(X)
        pk = self.packed
        trees = self.trees or _unpack_trees(
            pk.code.cpu(), pk.leaf_bot.cpu(), pk.E.cpu(), pk.depth)
        pred = np.full(len(X), float(pk.base), np.float32)
        for t in trees:
            pred += pk.lr * _predict_tree_np(t, X)
        return pred


class GBDTClassifier:
    """One-vs-rest stack of forests on one-hot targets; the class with the
    highest score wins.  After ``fit`` the class forests are stacked into
    one ``(C, T, S)`` pack over their shared bin grid."""

    def __init__(self, n_classes: int, cfg: Optional[GBDTConfig] = None,
                 packed: Optional[PackedForest] = None, device="cuda"):
        self.n_classes = int(n_classes)
        self.cfg = cfg if cfg is not None else GBDTConfig()
        self.packed = packed
        self.device = torch.device(device) if packed is None \
            else packed.E.device
        self.models: List[GBDTRegressor] = []

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GBDTClassifier":
        onehot = np.eye(self.n_classes, dtype=np.float32)[
            np.asarray(y, np.int64)]
        self.models = [GBDTRegressor(self.cfg, device=self.device)
                       .fit(X, onehot[:, k]) for k in range(self.n_classes)]
        packs = [m.packed for m in self.models]
        # every class forest was fit on the same X, so they share one grid
        self.packed = PackedForest(
            E=packs[0].E, code=torch.stack([p.code for p in packs]),
            leaf_bot=torch.stack([p.leaf_bot for p in packs]),
            base=torch.stack([p.base for p in packs]), lr=packs[0].lr,
            depth=packs[0].depth)
        return self

    def predict_scores(self, X: torch.Tensor) -> torch.Tensor:
        """(n, C) raw one-vs-rest scores."""
        pk = self.packed
        X = X.to(device=pk.E.device, dtype=torch.float32)
        lr = torch.tensor(pk.lr, dtype=torch.float32, device=X.device)
        return _by_row_blocks(
            lambda x: _forest_scan_multi(pk.code, pk.leaf_bot, x, pk.E,
                                         pk.base, lr, pk.depth), X)

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        return torch.argmax(self.predict_scores(X), dim=1).to(torch.int32)

    def predict_proba(self, X: torch.Tensor) -> torch.Tensor:
        return torch.softmax(self.predict_scores(X), dim=1)

    def _class_models(self) -> List[GBDTRegressor]:
        """One regressor per class: the fitted ones, or views of the
        stacked pack of a carried classifier."""
        if self.models:
            return self.models
        pk = self.packed
        return [GBDTRegressor(packed=PackedForest(
            E=pk.E, code=pk.code[c], leaf_bot=pk.leaf_bot[c],
            base=pk.base[c], lr=pk.lr, depth=pk.depth))
            for c in range(self.n_classes)]

    # -- numpy reference (per-class tree loops on the host) -----------------
    def predict_proba_np(self, X) -> np.ndarray:
        scores = np.stack([m.predict_np(X) for m in self._class_models()], 1)
        e = np.exp(scores - scores.max(1, keepdims=True))
        return e / e.sum(1, keepdims=True)

    def predict_np(self, X) -> np.ndarray:
        return self.predict_proba_np(X).argmax(1).astype(np.int32)


def forest_from_state(state: dict, prefix: str, device
                      ) -> Optional[PackedForest]:
    """The ``PackedForest`` stored under ``prefix`` in a state dict."""
    if f"{prefix}/code" not in state:
        return None
    return PackedForest.from_arrays(
        {k: state[f"{prefix}/{k}"]
         for k in ("E", "code", "leaf_bot", "base", "lr", "depth")}, device)
