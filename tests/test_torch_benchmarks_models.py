"""The port's fitted-model tables (``repro_torch.benchmarks``: Table 2,
Table 5, Table 6, GNN and feature throughput) against the JAX package's
``benchmarks/`` modules, on the CPU, each in a temporary working
directory.

Their derived fields are scores of GAN draws and times, equal to the JAX
module's only to a tolerance the scores' tests already hold
(``tests/test_torch_metrics.py``, ``test_torch_baselines.py``), so these
tests compare row names and result keys.  Both packages run their own
``run(fast=True)`` loops; in the port, on the CPU at depth cut for this
test (GAN steps and GBDT rounds, which no row name depends on), and in
the JAX package with its fits, draws and scores replaced by stand-ins,
whose compiles would take minutes.  The tables at their own depth run
on the card (``python -m repro_torch.benchmarks.run``).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (feature_throughput, gnn_throughput,
                                    table2_quality, table5_scale_metrics,
                                    table6_ablation)
from repro_torch.core.features import FEATURE_GENERATORS, GANFeatureGenerator
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.pipeline import SyntheticGraphPipeline

ROOT = Path(__file__).resolve().parents[1]

#: torch's intra-op threads in these tests
TORCH_THREADS = 2


@pytest.fixture(autouse=True)
def few_torch_threads():
    """``TORCH_THREADS`` intra-op threads for the port: the suite runs in
    several worker processes at once, and a full torch thread pool in
    each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)

#: the depth of the port's fits here
GAN_STEPS, GBDT_ROUNDS = 2, 2


@pytest.fixture
def jax_table(tmp_path, monkeypatch):
    """Load ``benchmarks/<name>.py`` by path, in a temporary working
    directory."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(ROOT))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"jax_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


class _ShortPipeline(SyntheticGraphPipeline):
    def __init__(self, *args, gan_steps=0, **kw):
        super().__init__(*args, gan_steps=GAN_STEPS, **kw)


class _ShortGAN(GANFeatureGenerator):
    def fit(self, cont, cat, steps=300, seed=0):
        return super().fit(cont, cat, steps=GAN_STEPS, seed=seed)


def _short(monkeypatch, mod):
    """Cut the port's table ``mod`` to ``GAN_STEPS``/``GBDT_ROUNDS``."""
    if hasattr(mod, "GBDTConfig"):
        monkeypatch.setattr(mod, "GBDTConfig", lambda **kw: GBDTConfig(
            **{**kw, "n_rounds": GBDT_ROUNDS}))
    if hasattr(mod, "SyntheticGraphPipeline"):
        monkeypatch.setattr(mod, "SyntheticGraphPipeline", _ShortPipeline)
    if hasattr(mod, "FEATURE_GENERATORS"):
        monkeypatch.setattr(mod, "FEATURE_GENERATORS",
                            {**FEATURE_GENERATORS, "gan": _ShortGAN})
    if hasattr(mod, "GANFeatureGenerator"):
        monkeypatch.setattr(mod, "GANFeatureGenerator", _ShortGAN)


class _Graph:
    n_edges = n_nodes = 1


class _Stand:
    """Any JAX component: fits to itself, draws nothing."""

    def __init__(self, *args, **kw):
        pass

    def fit(self, *args, **kw):
        return self

    def generate(self, *args, **kw):
        return _Graph(), None, None

    def sample(self, rng, *sizes):
        # features draw (rng, n) rows, structure (rng, scale, scale) graphs
        return (None, None) if len(sizes) == 1 else _Graph()

    def align(self, *args, **kw):
        return None, None


def _scores(*args, **kw):
    return {"degree_dist": 0.0, "feature_corr": 0.0,
            "degree_feat_dist": 0.0, "dcc": 0.0}


def _names(rows):
    return [r["name"] for r in rows]


def _finite_fields(rows):
    for r in rows:
        for kv in r["derived"].split(";"):
            assert np.isfinite(float(kv.split("=", 1)[1])), r


def test_table2_rows(jax_table, monkeypatch):
    jmod = jax_table("table2_quality")
    monkeypatch.setattr(jmod, "SyntheticGraphPipeline", _Stand)
    monkeypatch.setattr(jmod, "evaluate_all", _scores)
    want = jmod.run(fast=True)
    _short(monkeypatch, table2_quality)
    got = table2_quality.run(fast=True, device="cpu")
    assert _names(got) == _names(want) and len(got) == 9
    assert table2_quality.METHODS == jmod.METHODS
    _finite_fields(got)


def test_table5_rows(jax_table, monkeypatch):
    jmod = jax_table("table5_scale_metrics")
    monkeypatch.setattr(jmod, "SyntheticGraphPipeline", _Stand)
    monkeypatch.setattr(jmod, "evaluate_all", _scores)
    want = jmod.run(fast=True)
    _short(monkeypatch, table5_scale_metrics)
    got = table5_scale_metrics.run(fast=True, device="cpu")
    assert _names(got) == _names(want)
    # Eq. 22: nodes x k, edges x k^2 of the 4 000-edge table
    assert [r["derived"].split(";")[0] for r in got] == [
        f"E={4000 * k * k}" for k in (1, 2, 4)]
    _finite_fields(got)


def test_table6_rows(jax_table, monkeypatch):
    jmod = jax_table("table6_ablation")

    class _Fit:
        n = m = 1
    for name in ("SBMGenerator", "ERGenerator"):
        monkeypatch.setattr(jmod, name, _Stand)
    monkeypatch.setattr(jmod, "fit_structure", lambda g, noise: _Fit())
    monkeypatch.setattr(jmod.rmat, "sample_graph",
                        lambda key, fit: (np.zeros(1), np.zeros(1)))
    monkeypatch.setattr(jmod, "FEATURE_GENERATORS",
                        {k: _Stand for k in jmod.FEATURE_GENERATORS})
    monkeypatch.setattr(jmod, "ALIGNERS", {k: _Stand for k in jmod.ALIGNERS})
    monkeypatch.setattr(jmod, "evaluate_all", _scores)
    want = jmod.run(fast=True)
    _short(monkeypatch, table6_ablation)
    got = table6_ablation.run(fast=True, device="cpu")
    assert _names(got) == _names(want) and len(got) == 18
    _finite_fields(got)


def test_gnn_rows(jax_table, monkeypatch):
    jmod = jax_table("gnn_throughput")
    monkeypatch.setattr(jmod, "SyntheticGraphPipeline", _Stand)
    monkeypatch.setattr(jmod, "_epoch_time", lambda g, **kw: 1.0)
    want = jmod.run(fast=True)
    got = gnn_throughput.run(fast=True, device="cpu")
    assert _names(got) == _names(want)
    rel = {r["name"]: float(r["derived"].split("=")[1]) for r in got}
    assert rel["gnn/gcn/original"] == rel["gnn/gat/original"] == 1.0
    assert all(r["us_per_call"] > 0 and v <= 1.0 for r, v in
               zip(got, rel.values()))


def test_feature_throughput_keys(jax_table, monkeypatch):
    """The JAX module's stages are timed by ``_stage``/``_rows_per_sec``;
    with those replaced, its run still fits its GAN and aligner, so its
    GAN steps and GBDT rounds are cut too."""
    import repro.core.features as jfeatures
    from repro.core.gbdt import GBDTConfig as JGBDTConfig
    jmod = jax_table("feature_throughput")

    def stage(ref_fn, ref_rows, engine_fn, engine_rows, repeats):
        return {"reference_rows": ref_rows, "engine_rows": engine_rows,
                "reference_rows_per_s": 1.0, "engine_rows_per_s": 1.0,
                "speedup_vs_reference": 1.0}
    monkeypatch.setattr(jmod, "_stage", stage)
    monkeypatch.setattr(jmod, "_rows_per_sec", lambda *a, **kw: 1.0)
    monkeypatch.setattr(jmod, "GBDTConfig", lambda **kw: JGBDTConfig(
        **{**kw, "n_rounds": GBDT_ROUNDS}))

    class _JShortGAN(jfeatures.GANFeatureGenerator):
        def fit(self, cont, cat, steps=300, seed=0):
            return super().fit(cont, cat, steps=GAN_STEPS, seed=seed)
    monkeypatch.setattr(jmod, "GANFeatureGenerator", _JShortGAN)
    want = jmod.run(fast=True)
    _short(monkeypatch, feature_throughput)
    got = feature_throughput.run(fast=True, device="cpu")
    assert got.keys() == want.keys()
    for k in ("rows", "reference_rows", "batch"):
        assert got[k] == want[k]
    for k in ("decode", "gan_sample", "gbdt_predict", "align"):
        assert got[k].keys() == want[k].keys()
        for rows in ("reference_rows", "engine_rows"):
            assert got[k][rows] == want[k][rows]
        assert got[k]["engine_rows_per_s"] > 0
        assert got[k]["reference_rows_per_s"] > 0
    assert got["decode"]["numpy_rows_per_s"] > 0
