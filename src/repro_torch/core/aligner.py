"""Aligner (paper §3.4, App. 7): map generated feature rows onto generated
structure so structure↔feature correlations of the original graph
survive.

Structural features per node (degree, PageRank, Katz) feed per-column
GBDT predictors (edge columns see ``[F_S(src), F_S(dst)]``).  ``fit``
computes them on the graph's device, fits the forests on the host
(``gbdt``) and scores each column on a 20% holdout through the device
predictors: R² for continuous columns, accuracy over the majority rate
for categorical ones; the two best columns key the matching.  Rows are
assigned by rank matching on the two best-predicted columns: both the
predictions and the generated rows are keyed, sorted, and matched by
rank.  The rank-matching noise is drawn from the caller's numpy
Generator in the reference's call order, so the same seed gives the same
assignment; sorting is stable (``torch.sort(stable=True)``).
``RandomAligner`` is the ablation baseline.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.feature_engine import batched_rows
from repro_torch.core.gbdt import GBDTClassifier, GBDTConfig, GBDTRegressor
from repro_torch.graph.ops import Graph, node_features
from repro_torch.tabular.schema import TableSchema


@dataclasses.dataclass
class AlignerConfig:
    gbdt: GBDTConfig = dataclasses.field(
        default_factory=lambda: GBDTConfig(n_rounds=100, max_depth=5, lr=0.1,
                                           alpha=10.0))
    max_cat_classes: int = 16     # one-vs-rest cap for categorical columns


def _require_rng(rng: Optional[np.random.Generator],
                 who: str) -> np.random.Generator:
    if rng is None:
        raise ValueError(
            f"{who}: pass rng= (a np.random.Generator derived from the "
            f"job seed) — alignment noise must not fall back to a "
            f"hidden constant-seed stream")
    return rng


def _stable_argsort(x: torch.Tensor) -> torch.Tensor:
    return torch.sort(x, stable=True).indices


def _lexsort(secondary: torch.Tensor, primary: torch.Tensor
             ) -> torch.Tensor:
    """``np.lexsort((secondary, primary))``: order by ``primary``, ties by
    ``secondary``, remaining ties by index."""
    o = _stable_argsort(secondary)
    return o[_stable_argsort(primary[o])]


class GBDTAligner:
    """Per-column GBDT predictor + rank matching.  Built unfitted (then
    ``fit``), or fitted from its models and their holdout qualities
    (``repro_torch.convert``)."""

    def __init__(self, schema: TableSchema,
                 cfg: Optional[AlignerConfig] = None, kind: str = "edge", *,
                 cont_models: Optional[List[GBDTRegressor]] = None,
                 cat_models: Optional[List[Optional[GBDTClassifier]]] = None,
                 col_quality: Optional[List[float]] = None):
        assert kind in ("edge", "node")
        self.schema = schema
        self.cfg = cfg if cfg is not None else AlignerConfig()
        self.kind = kind
        self.cont_models = list(cont_models or [])
        self.cat_models = list(cat_models or [])
        self.col_quality = list(col_quality or [])

    def _inputs(self, g: Graph) -> torch.Tensor:
        feats = node_features(g)
        if self.kind == "node":
            return feats[: g.n_src] if not g.bipartite else feats
        dst = g.dst + (g.n_src if g.bipartite else 0)
        return torch.cat([feats[g.src], feats[dst]], dim=1)

    def fit(self, g: Graph, cont: np.ndarray, cat: np.ndarray
            ) -> "GBDTAligner":
        """Fit one forest (stack) per column on the first 80% of rows and
        score it on the rest.  With no holdout row every quality is 0.5;
        categorical columns above ``max_cat_classes`` get no model."""
        X_dev = self._inputs(g).to(torch.float32)
        X = X_dev.cpu().numpy()
        n = min(len(X), len(cont) if cont.size else len(X),
                len(cat) if cat.size else len(X))
        X, X_dev = X[:n], X_dev[:n]
        n_tr = max(1, int(n * 0.8))
        no_holdout = n_tr >= n
        dev = X_dev.device
        self.col_quality = []
        self.cont_models = []
        for j in range(self.schema.n_cont):
            m = GBDTRegressor(self.cfg.gbdt, device=dev).fit(
                X[:n_tr], cont[:n_tr, j])
            self.cont_models.append(m)
            if no_holdout:
                self.col_quality.append(0.5)
                continue
            y = cont[n_tr:n, j]
            p = m.predict(X_dev[n_tr:n]).cpu().numpy()
            var = y.var() + 1e-12
            self.col_quality.append(
                float(max(0.0, 1.0 - ((p - y) ** 2).mean() / var)))
        self.cat_models = []
        for j, card in enumerate(self.schema.cat_cards):
            if card > self.cfg.max_cat_classes:
                self.cat_models.append(None)  # too many classes: rank on cont
                continue
            m = GBDTClassifier(card, self.cfg.gbdt, device=dev).fit(
                X[:n_tr], cat[:n_tr, j])
            self.cat_models.append(m)
            if no_holdout:
                self.col_quality.append(0.5)
                continue
            y = cat[n_tr:n, j]
            acc = float((m.predict(X_dev[n_tr:n]).cpu().numpy() == y).mean())
            base = max(np.bincount(y, minlength=card)) / max(len(y), 1)
            self.col_quality.append(max(0.0, acc - float(base)))
        return self

    def _col_costs(self) -> List[int]:
        """Forest count behind each column."""
        return ([1] * len(self.cont_models)
                + [m.n_classes for m in self.cat_models if m is not None])

    def _key_order(self) -> Tuple[int, int]:
        """(primary, secondary) column indices by holdout quality; ties
        break toward the cheapest predictor, then the lowest index."""
        if not self.col_quality:
            return 0, 0
        cost = self._col_costs()
        order_cols = sorted(range(len(self.col_quality)),
                            key=lambda i: (-self.col_quality[i], cost[i], i))
        prim = order_cols[0]
        sec = order_cols[1] if len(order_cols) > 1 else prim
        return prim, sec

    def _predict_col(self, X: torch.Tensor, ci: int,
                     batch: Optional[int] = None) -> torch.Tensor:
        """One column of the prediction without scoring the others."""
        specs = ([m.predict for m in self.cont_models]
                 + [m.predict for m in self.cat_models if m is not None])
        if not specs:
            return torch.zeros(len(X), dtype=torch.float32, device=X.device)
        fn = specs[ci]
        out = batched_rows(fn, X, batch) if batch else fn(X)
        return out.to(torch.float32)

    def _rows_col(self, cont_rows, cat_rows, ci: int) -> torch.Tensor:
        if not self.col_quality:
            return torch.zeros(len(cont_rows), dtype=torch.float32,
                               device=cont_rows.device)
        if ci < self.schema.n_cont:
            return cont_rows[:, ci].to(torch.float32)
        included = [j for j, m in enumerate(self.cat_models) if m is not None]
        return cat_rows[:, included[ci - self.schema.n_cont]].to(
            torch.float32)

    def _match_keys_cols(self, pred2: torch.Tensor, rows2: torch.Tensor,
                         rng: np.random.Generator, q: float
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hierarchical rank keys over (primary, secondary) column pairs:
        the primary key, with noise ε ~ N(0, 1/R² − 1) on the prediction
        side, is ranked and bucketed at √n resolution; the secondary
        breaks ties within buckets.  Noise is float64, drawn by ``rng``."""
        n = len(pred2)
        dev = pred2.device
        n_buckets = max(1, int(np.sqrt(n)))
        r2 = float(np.clip(q, 0.05, 0.98))
        s = np.sqrt(1.0 / r2 - 1.0)

        def noise(scale):
            return torch.as_tensor(rng.normal(0, scale, n), device=dev)

        def keys(mat, noise_s):
            col = mat[:, 0]
            sd = col.std(unbiased=False) + 1e-9
            key = (col / sd).to(torch.float64) + noise(noise_s + 1e-9)
            ranks = torch.empty(n, dtype=torch.int64, device=dev)
            ranks[_stable_argsort(key)] = torch.arange(n, device=dev)
            bucket = ranks * n_buckets // n
            sec = mat[:, 1].to(torch.float64) + noise(1e-9)
            return _lexsort(sec, bucket)

        return keys(pred2, s), keys(rows2, 0.0)

    def align(self, g: Graph, cont_rows: torch.Tensor, cat_rows: torch.Tensor,
              rng: Optional[np.random.Generator] = None,
              batch: Optional[int] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Assign generated rows to edges (or nodes): the rows permuted
        into edge/node order.  Only the primary and secondary key
        columns' predictors are evaluated."""
        rng = _require_rng(rng, "GBDTAligner.align")
        X = self._inputs(g).to(torch.float32)
        n = min(len(X), len(cont_rows))
        X = X[:n]
        prim, sec = self._key_order()
        p_prim = self._predict_col(X, prim, batch)
        p_sec = (p_prim if sec == prim
                 else self._predict_col(X, sec, batch))
        del X
        pred2 = torch.stack([p_prim, p_sec], 1)
        rows2 = torch.stack([self._rows_col(cont_rows[:n], cat_rows[:n], prim),
                             self._rows_col(cont_rows[:n], cat_rows[:n], sec)],
                            1)
        q = self.col_quality[prim] if self.col_quality else 0.05
        order_pred, order_rows = self._match_keys_cols(pred2, rows2, rng, q)
        perm = torch.empty(n, dtype=torch.int64, device=order_pred.device)
        perm[order_pred] = order_rows
        return cont_rows[:n][perm], cat_rows[:n][perm]


class RandomAligner:
    """Ablation baseline: random permutation of generated rows."""

    def __init__(self, schema: TableSchema, kind: str = "edge"):
        self.schema = schema
        self.kind = kind

    def fit(self, g: Graph, cont, cat) -> "RandomAligner":
        return self

    def align(self, g: Graph, cont_rows, cat_rows, rng=None, batch=None):
        """Truncates to the graph's edge/node count like the GBDT path;
        ``batch`` is accepted and ignored."""
        rng = _require_rng(rng, "RandomAligner.align")
        n_target = g.n_edges if self.kind == "edge" else g.n_nodes
        n = min(len(cont_rows), n_target)
        perm = torch.as_tensor(rng.permutation(len(cont_rows))[:n],
                               device=cont_rows.device)
        return cont_rows[perm], cat_rows[perm]


ALIGNERS = {"xgboost": GBDTAligner, "gbdt": GBDTAligner,
            "random": RandomAligner}
