"""The aligner's, the GBDT's and the sampler registry's public API in the
port against the JAX package's, on the CPU.

An aligner fitted by the JAX package is carried across with
``repro_torch.convert`` and both are asked the same questions on the same
inputs.  Class ids, rank keys, row matrices and the numpy references are
exact; scores through the packed scans are held within ``SCORE_TOL``
(float32 sums of the same leaves, each framework rounding its own
multiply-adds)."""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core.aligner import AlignerConfig as JAlignerConfig
from repro.core.aligner import GBDTAligner as JGBDTAligner
from repro.core.gbdt import GBDTClassifier as JGBDTClassifier
from repro.core.gbdt import GBDTConfig as JGBDTConfig
from repro.core.gbdt import GBDTRegressor as JGBDTRegressor
from repro.core import sampler as jsampler
from repro.data.reference import tabformer_like
from repro.graph import ops as jops
from repro.tabular import schema as jschema
from repro_torch import convert, random as tr
from repro_torch.core import sampler
from repro_torch.core.gbdt import GBDTClassifier, GBDTConfig, GBDTRegressor
from repro_torch.graph import ops
from repro_torch.graph.ops import Graph
from repro_torch.tabular import schema
from repro_torch.tabular.schema import TableSchema

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

#: packed-scan scores: the port's against the JAX package's
SCORE_TOL = 1e-6


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_torch_state", ROOT / "scripts" / "export_torch_state.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _carry(jal):
    """The JAX aligner's state (as ``scripts/export_torch_state.py``
    writes it) → the port's aligner on the CPU."""
    forest = _export_module()._forest
    state = {"aligner/kind": np.str_("xgboost"),
             "aligner/col_quality": np.asarray(jal.col_quality, np.float64),
             "aligner/max_cat_classes": np.int64(jal.cfg.max_cat_classes)}
    for j, m in enumerate(jal.cont_models):
        forest(state, f"aligner/cont/{j}", m._binned, m.base, m.cfg)
    for j, m in enumerate(jal.cat_models):
        if m is not None:
            forest(state, f"aligner/cat/{j}", m._binned, np.asarray(m._base),
                   m.cfg, m.n_classes)
    sch = TableSchema(jal.schema.n_cont, tuple(jal.schema.cat_cards))
    return convert.aligner_from_state(state, sch, jal.kind, device="cpu")


def _jfit(seed: int):
    g, cont, cat = tabformer_like(seed=seed, n_src=256, n_dst=64,
                                  n_edges=2000)
    sch = jschema.infer_schema(cont, cat)
    # cat cards (6, 8, 2): the 8-class column gets no model
    return JGBDTAligner(sch, JAlignerConfig(gbdt=JGBDTConfig(n_rounds=10),
                                            max_cat_classes=7),
                        kind="edge").fit(g, cont, cat)


@pytest.fixture(scope="module")
def aligners():
    jal = _jfit(0)
    g, cont, cat = tabformer_like(seed=5, n_src=256, n_dst=64, n_edges=3000)
    X = np.asarray(jal._inputs(g), np.float32)
    return jal, _carry(jal), X, cont, cat


def test_carried_aligner_has_the_same_columns(aligners):
    jal, al, _, _, _ = aligners
    assert [m is None for m in al.cat_models] == \
        [m is None for m in jal.cat_models] == [False, True, False]
    assert al.col_quality == pytest.approx(jal.col_quality, abs=0)
    assert al._key_order() == jal._key_order()


@pytest.mark.parametrize("batch", [None, 512])
def test_predict_rows_equals_reference(aligners, batch):
    jal, al, X, _, _ = aligners
    assert al._packed_rows() is not None and jal._packed_rows() is not None
    want = jal.predict_rows(X, batch=batch)
    got = al.predict_rows(torch.from_numpy(X), batch=batch).numpy()
    assert got.shape == want.shape == (len(X), 4) and got.dtype == np.float32
    nc = jal.schema.n_cont
    np.testing.assert_allclose(got[:, :nc], want[:, :nc], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(got[:, nc:], want[:, nc:])


def test_predict_rows_per_column_path(aligners):
    """Forests from two fits share no bin grid: both packages refuse the
    packed scan and score column by column, with the same results.  The
    port's pack follows its models: swapping a forest in after a packed
    prediction leaves no stale pack behind."""
    jal, _, X, _, _ = aligners
    jmix = _jfit(0)
    jmix.cont_models[1] = _jfit(1).cont_models[1]
    mix = _carry(jal)
    assert mix._packed_rows() is not None
    mix.predict_rows(torch.from_numpy(X))
    mix.cont_models[1] = _carry(jmix).cont_models[1]
    assert jmix._packed_rows() is None and mix._packed_rows() is None
    want = jmix.predict_rows(X)
    got = mix.predict_rows(torch.from_numpy(X)).numpy()
    nc = jal.schema.n_cont
    np.testing.assert_allclose(got[:, :nc], want[:, :nc], rtol=SCORE_TOL,
                               atol=SCORE_TOL)
    np.testing.assert_array_equal(got[:, nc:], want[:, nc:])


def test_predict_of_a_graph_is_predict_rows_of_its_inputs(aligners):
    jal, al, _, _, _ = aligners
    jg, _, _ = tabformer_like(seed=5, n_src=256, n_dst=64, n_edges=3000)
    g = Graph(torch.from_numpy(np.asarray(jg.src)),
              torch.from_numpy(np.asarray(jg.dst)), jg.n_src, jg.n_dst,
              jg.bipartite)
    got = al.predict(g).numpy()
    np.testing.assert_array_equal(got,
                                  al.predict_rows(al._inputs(g)).numpy())
    want = jal.predict(jg)
    nc = jal.schema.n_cont
    np.testing.assert_array_equal(got[:, nc:], want[:, nc:])
    np.testing.assert_allclose(got[:, :nc], want[:, :nc], rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_gbdt_numpy_references_equal(aligners):
    jal, al, X, _, _ = aligners
    for jm, m in zip(jal.cont_models, al.cont_models):
        assert not m.trees        # carried: the trees come from the pack
        np.testing.assert_array_equal(m.predict_np(X), jm.predict_np(X))
        np.testing.assert_array_equal(m.predict_np(torch.from_numpy(X)),
                                      jm.predict_np(X))
    for jm, m in zip(jal.cat_models, al.cat_models):
        if jm is None:
            continue
        np.testing.assert_array_equal(m.predict_np(X), jm.predict_np(X))
        np.testing.assert_allclose(m.predict_proba_np(X),
                                   jm.predict_proba_np(X), rtol=SCORE_TOL,
                                   atol=SCORE_TOL)
        proba = m.predict_proba(torch.from_numpy(X)).numpy()
        np.testing.assert_allclose(proba, np.asarray(jm.predict_proba(X)),
                                   rtol=SCORE_TOL, atol=SCORE_TOL)
        np.testing.assert_allclose(proba.sum(1), 1.0, rtol=0, atol=1e-6)
        np.testing.assert_array_equal(
            m.predict(torch.from_numpy(X)).numpy(), np.asarray(jm.predict(X)))


def test_gbdt_fitted_in_the_port_numpy_reference():
    """A forest fitted by the port keeps its host trees; ``predict_np`` on
    them is the JAX package's on the same fit, and equals the numpy walk
    of the trees unpacked from its own bin pack."""
    rng = np.random.default_rng(0)
    X = rng.normal(size=(600, 3)).astype(np.float32)
    y = (X[:, 0] * 2 + np.sin(X[:, 1])).astype(np.float32)
    cfg = dict(n_rounds=8, max_depth=4)
    m = GBDTRegressor(GBDTConfig(**cfg), device="cpu").fit(X, y)
    jm = JGBDTRegressor(JGBDTConfig(**cfg)).fit(X, y)
    Xq = rng.normal(size=(300, 3)).astype(np.float32)
    assert m.trees
    np.testing.assert_array_equal(m.predict_np(Xq), jm.predict_np(Xq))
    carried = GBDTRegressor(packed=m.packed)
    np.testing.assert_array_equal(carried.predict_np(Xq), m.predict_np(Xq))

    k = (X[:, 0] > 0).astype(np.int32) + (X[:, 2] > 1)
    c = GBDTClassifier(3, GBDTConfig(**cfg), device="cpu").fit(X, k)
    jc = JGBDTClassifier(3, JGBDTConfig(**cfg)).fit(X, k)
    np.testing.assert_array_equal(c.predict_np(Xq), jc.predict_np(Xq))
    np.testing.assert_array_equal(c.predict_proba_np(Xq),
                                  jc.predict_proba_np(Xq))


def test_match_keys_and_rows_matrix_equal(aligners):
    jal, al, X, cont, cat = aligners
    pred = jal.predict_rows(X)
    n = len(pred)
    rows_j = jal._rows_matrix(cont[:n], cat[:n])
    rows = al._rows_matrix(torch.from_numpy(cont[:n]),
                           torch.from_numpy(cat[:n]))
    np.testing.assert_array_equal(rows.numpy(), rows_j)
    jo_p, jo_r = jal._match_keys(pred, rows_j, np.random.default_rng(7))
    o_p, o_r = al._match_keys(torch.from_numpy(pred), rows,
                              np.random.default_rng(7))
    np.testing.assert_array_equal(o_p.numpy(), jo_p)
    np.testing.assert_array_equal(o_r.numpy(), jo_r)


def test_similarity_equals_reference(aligners):
    jal, al, X, cont, cat = aligners
    pred = jal.predict_rows(X)
    n = len(pred)
    rows = jal._rows_matrix(cont[:n], cat[:n])
    want = jal.similarity(pred, rows)
    got = al.similarity(torch.from_numpy(pred), torch.from_numpy(rows))
    np.testing.assert_allclose(got.numpy(), want, rtol=SCORE_TOL,
                               atol=SCORE_TOL)


def test_sampler_availability():
    card = torch.cuda.is_available()
    assert sampler.registered_backends() == ["reference", "cuda_bits",
                                             "cuda_prng"]
    assert sampler.available_backends() == (
        ["reference", "cuda_bits", "cuda_prng"] if card else ["reference"])
    assert sampler.get_backend("reference").why_unavailable() is None
    assert jsampler.get_backend("xla").why_unavailable() is None
    for name in ("cuda_bits", "cuda_prng"):
        be = sampler.get_backend(name)
        assert be.available() == card
        if not card:
            assert "no CUDA card" in be.why_unavailable()
            # reporting it falls back to nothing: the card stays required
            with pytest.raises((RuntimeError, ValueError, AssertionError)):
                be.sample(tr.PRNGKey(0), np.tile([.45, .22, .2, .13],
                                                 (4, 1)), 4, 4, 64,
                          device="cuda")


@pytest.mark.parametrize("n_dst", [7, 1 << 20])
def test_dedup_edges_equals_reference(n_dst):
    rng = np.random.default_rng(n_dst)
    src = rng.integers(0, 40, 5000).astype(np.int32)
    dst = rng.integers(0, min(n_dst, 30), 5000).astype(np.int32)
    got = ops.dedup_edges(src, dst, n_dst)
    want = jops.dedup_edges(src, dst, n_dst)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, np.asarray(b))
        assert a.dtype == np.asarray(b).dtype


def test_split_columns_equals_reference():
    rng = np.random.default_rng(3)
    x = np.stack([rng.normal(size=200), rng.integers(5, 9, 200),
                  rng.exponential(size=200), rng.choice([-1.5, 2.0, 7.25],
                                                        200)], 1)
    got = schema.split_columns(x, [0, 2], [1, 3])
    want = jschema.split_columns(x, [0, 2], [1, 3])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
