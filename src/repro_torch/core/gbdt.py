"""Gradient-boosted tree inference — the aligner's predictor R.

Forests are fitted by the JAX package (numpy histogram trees) and cross
over in its bin-quantized pack (``_pack_binned``): per forest

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
from typing import Optional

import numpy as np
import torch

#: rows per descent block: bounds the int64 index temporaries
_ROW_BLOCK = 1 << 24


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
    def __init__(self, packed: PackedForest):
        self.packed = packed

    def predict(self, X: torch.Tensor) -> torch.Tensor:
        pk = self.packed
        X = X.to(device=pk.E.device, dtype=torch.float32)
        lr = torch.tensor(pk.lr, dtype=torch.float32, device=X.device)
        return _by_row_blocks(
            lambda x: _forest_scan(pk.code, pk.leaf_bot, x, pk.E, pk.base,
                                   lr, pk.depth), X)


class GBDTClassifier:
    """One-vs-rest stack of forests on one-hot targets; the class with the
    highest score wins."""

    def __init__(self, n_classes: int, packed: PackedForest):
        self.n_classes = int(n_classes)
        self.packed = packed

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


def forest_from_state(state: dict, prefix: str, device
                      ) -> Optional[PackedForest]:
    """The ``PackedForest`` stored under ``prefix`` in a state dict."""
    if f"{prefix}/code" not in state:
        return None
    return PackedForest.from_arrays(
        {k: state[f"{prefix}/{k}"]
         for k in ("E", "code", "leaf_bot", "base", "lr", "depth")}, device)
