"""The port's vectorized histogram-tree fit (``repro_torch.core.gbdt.
_fit_tree``) against the JAX package's per-node, per-feature loop on the
same inputs: every tree equal, leaves bit for bit.  The cases reach the
loop's corners: gains tied across features and bins, a constant
feature, nodes at ``2 * min_child`` rows, thresholds past the last bin
edge (+inf), deeper trees with single-row children, and a NaN gradient.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

from repro.core import gbdt as jgbdt
from repro_torch.core import gbdt


def _trees_equal(a, b) -> bool:
    return (np.array_equal(a.feature, b.feature)
            and np.array_equal(a.threshold.view(np.int32),
                               b.threshold.view(np.int32))
            and np.array_equal(a.leaf.view(np.int32), b.leaf.view(np.int32))
            and np.array_equal(a.is_leaf, b.is_leaf))


def _bins(X, n_bins):
    return [np.unique(np.quantile(X[:, j],
                                  np.linspace(0, 1, n_bins + 1)[1:-1]))
            for j in range(X.shape[1])]


def _case(name: str):
    rng = np.random.default_rng(7)
    cfg = gbdt.GBDTConfig()
    if name == "random":
        n = 3000
        X = rng.normal(size=(n, 6)).astype(np.float32)
        grad = (X[:, 0] * 3 + rng.normal(size=n)).astype(np.float32)
    elif name == "tied_features":
        n = 2000
        c = rng.pareto(1.5, n).astype(np.float32)
        X = np.stack([c, c, c * 2], 1)       # the same order three times
        grad = (np.log1p(c) * 40).astype(np.float32)
    elif name == "constant_feature":
        n = 1500
        X = np.stack([np.full(n, 3.0), rng.random(n)], 1).astype(np.float32)
        grad = (X[:, 1] * 50 - 25).astype(np.float32)
    elif name == "few_rows":
        n = 9                                # the root alone can split
        X = rng.random((n, 3)).astype(np.float32)
        grad = np.linspace(-60, 60, n).astype(np.float32)
    elif name == "inf_values":
        n = 2000
        X = rng.random((n, 2)).astype(np.float32)
        X[rng.random(n) < 0.4, 0] = np.inf
        grad = np.where(np.isinf(X[:, 0]), 30.0, -20.0).astype(np.float32)
    elif name == "deep_min_child_1":
        n = 400
        X = rng.integers(0, 6, (n, 4)).astype(np.float32)
        grad = (rng.normal(size=n) * 30).astype(np.float32)
        cfg = dataclasses.replace(cfg, max_depth=7, min_child=1, alpha=0.0)
    elif name == "nan_gradient":
        n = 1000
        X = rng.random((n, 3)).astype(np.float32)
        grad = (X[:, 2] * 80 - 40).astype(np.float32)
        grad[5] = np.nan
    else:
        raise ValueError(name)
    return X, grad, cfg


CASES = ["random", "tied_features", "constant_feature", "few_rows",
         "inf_values", "deep_min_child_1", "nan_gradient"]


@pytest.mark.parametrize("name", CASES)
def test_fit_tree_equals_reference(name):
    X, grad, cfg = _case(name)
    jcfg = jgbdt.GBDTConfig(**dataclasses.asdict(cfg))
    bins = _bins(X, cfg.n_bins)
    want = jgbdt._fit_tree(X, grad, jcfg, bins)
    got = gbdt._fit_tree(X, grad, cfg, bins)
    assert _trees_equal(got, want)
    # the keys a forest bins once give the same tree
    keys = gbdt._bin_keys(X, bins, cfg.n_bins)
    assert _trees_equal(gbdt._fit_tree(X, grad, cfg, bins, keys), want)


@pytest.mark.parametrize("name", ["random", "tied_features", "inf_values"])
def test_boosted_forest_equals_reference(name):
    """A whole boosted forest (the keys binned once for all its trees)."""
    X, grad, cfg = _case(name)
    y = -grad
    cfg = dataclasses.replace(cfg, n_rounds=8)
    want = jgbdt.GBDTRegressor(jgbdt.GBDTConfig(
        **dataclasses.asdict(cfg))).fit(X, y)
    got = gbdt.GBDTRegressor(cfg, device="cpu").fit(X, y)
    assert len(got.trees) == len(want.trees) == 8
    assert all(_trees_equal(a, b) for a, b in zip(got.trees, want.trees))
