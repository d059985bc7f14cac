"""The port's generation slice against the JAX package, end to end.

A small JAX pipeline is fitted once per module, carried across with
``scripts/export_torch_state.py``'s ``state_from_jax_pipeline``, and both
generate from the same seed.  Tolerances and why:

* struct ids: exact — same threefry stream, same integer descend;
* GAN generator output per block: 1e-5 absolute — float32 matmul and
  batch-norm reductions are summed in another order than XLA's;
* mode / category ids: equal on ≥ 99.9% of rows — a Gumbel-max argmax
  can flip where two logits tie to within those last ulps;
* GBDT scores: 1e-5 absolute — the descent is integer, only the float32
  ``carry + lr * leaf`` sums can round apart;
* aligned rows: equal on ≥ 99% of rows — rank matching sorts keys built
  from all of the above, so a near-tie moves a row to a neighbour slot.
"""
import importlib.util
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import features as jfeatures
from repro.core.aligner import AlignerConfig as JAlignerConfig
from repro.core.gbdt import GBDTConfig
from repro.core.pipeline import SyntheticGraphPipeline as JPipeline
from repro.data.reference import tabformer_like
from repro.graph import ops as jgops
from repro_torch import convert, random as tr
from repro_torch.graph import ops as gops

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """Torch's CPU ops on one thread: these draws run about as fast on one
    as on eight, and no thread pool is left spinning when the suite runs
    several test processes side by side."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_torch_state", ROOT / "scripts" / "export_torch_state.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def fitted():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")
    g, cont, cat = tabformer_like(n_src=256, n_dst=64, n_edges=2000)
    jpipe = JPipeline(struct="kronecker", features="gan", aligner="xgboost",
                      noise=0.03, gan_steps=10,
                      aligner_cfg=JAlignerConfig(gbdt=GBDTConfig(n_rounds=10)))
    jpipe.fit(g, cont, cat)
    state = _export_module().state_from_jax_pipeline(jpipe)
    return jpipe, state, convert.pipeline_from_state(state, device="cpu")


def _row_match(c1, k1, c2, k2) -> float:
    same_cat = (np.asarray(k1) == np.asarray(k2)).all(1)
    same_cont = np.isclose(np.asarray(c1), np.asarray(c2), rtol=1e-5,
                           atol=1e-5).all(1)
    return float((same_cat & same_cont).mean())


@pytest.mark.parametrize("backend,jbackend", [("reference", "xla"),
                                              ("cuda_bits", "pallas_bits")])
@pytest.mark.parametrize("chunked", [False, True])
def test_generate_matches_reference(fitted, backend, jbackend, chunked):
    jpipe, _, pipe = fitted
    # k_pref=1: four chunks keep the reference's per-chunk compiles cheap
    g1, c1, k1 = jpipe.generate(seed=3, scale_nodes=2, chunked=chunked,
                                k_pref=1, backend=jbackend)
    g2, c2, k2 = pipe.generate(seed=3, scale_nodes=2, chunked=chunked,
                               k_pref=1, backend=backend)
    np.testing.assert_array_equal(g2.src.numpy(), np.asarray(g1.src))
    np.testing.assert_array_equal(g2.dst.numpy(), np.asarray(g1.dst))
    assert (g2.n_src, g2.n_dst, g2.bipartite) == (g1.n_src, g1.n_dst,
                                                  g1.bipartite)
    assert c2.shape == c1.shape and k2.shape == k1.shape
    assert c2.dtype == torch.float32 and k2.dtype == torch.int32
    assert _row_match(c1, k1, c2, k2) >= 0.99


def test_gan_block_matches_reference(fitted):
    """Same z through both generators (per block, batch statistics), then
    the same key through both Gumbel-max decoders."""
    jpipe, _, pipe = fitted
    jgan, gan = jpipe.features, pipe.features
    b = 4096
    z = np.random.default_rng(0).standard_normal((b, jgan.cfg.d_z)) \
        .astype(np.float32)
    raw_j = np.array(jgan._activate(jfeatures._mlp(
        jgan.params["g"], z, jax.random.PRNGKey(0), 0.0, False)))
    with torch.no_grad():
        raw_t = gan._activate(gan.generator(torch.from_numpy(z)))
    np.testing.assert_allclose(raw_t.numpy(), raw_j, rtol=0, atol=1e-5)

    key = 17
    cj, kj = jgan.codec.batched(b).decode_traceable(
        raw_j, jax.random.PRNGKey(key))
    ct, kt = gan.codec.batched(b, "cpu").decode_traceable(
        torch.from_numpy(raw_j), tr.PRNGKey(key))
    assert (kt.numpy() == np.asarray(kj)).all(1).mean() >= 0.999
    assert np.isclose(ct.numpy(), np.asarray(cj), rtol=1e-5,
                      atol=1e-5).all(1).mean() >= 0.999

    # the whole block draw, noise included
    cj, kj = jgan.block_draw(b)(jgan.params["g"], jax.random.PRNGKey(key))
    ct, kt = gan.block_draw(b)(tr.PRNGKey(key))
    assert _row_match(cj, kj, ct, kt) >= 0.999


def test_gbdt_scores_match_reference(fitted):
    jpipe, _, pipe = fitted
    g, _, _ = tabformer_like(seed=5, n_src=256, n_dst=64, n_edges=3000)
    X = np.asarray(jpipe.aligner._inputs(g), np.float32)
    Xt = torch.from_numpy(X)
    for jm, tm in zip(jpipe.aligner.cont_models, pipe.aligner.cont_models):
        np.testing.assert_allclose(tm.predict(Xt).numpy(),
                                   np.asarray(jm.predict(X)), rtol=0,
                                   atol=1e-5)
    for jm, tm in zip(jpipe.aligner.cat_models, pipe.aligner.cat_models):
        assert (jm is None) == (tm is None)
        if jm is None:
            continue
        np.testing.assert_allclose(tm.predict_scores(Xt).numpy(),
                                   np.asarray(jm.predict_scores(X)), rtol=0,
                                   atol=1e-5)
        assert (tm.predict(Xt).numpy() == np.asarray(jm.predict(X))
                ).mean() >= 0.999


def test_node_features_match_reference():
    """Degrees exactly; PageRank and Katz to float32 summation order."""
    g, _, _ = tabformer_like(seed=2, n_src=300, n_dst=40, n_edges=2500)
    want = np.asarray(jgops.node_features(g))
    got = gops.node_features(gops.Graph(torch.from_numpy(g.src),
                                        torch.from_numpy(g.dst), g.n_src,
                                        g.n_dst, g.bipartite)).numpy()
    np.testing.assert_array_equal(got[:, :2], want[:, :2])
    np.testing.assert_allclose(got[:, 2:], want[:, 2:], rtol=1e-5, atol=1e-6)


def test_state_round_trip(fitted, tmp_path):
    _, state, _ = fitted
    path = tmp_path / "fit.npz"
    convert.save_state(state, path)
    back = convert.load_state(path)
    assert set(back) == set(state)
    for k in state:
        np.testing.assert_array_equal(back[k], np.asarray(state[k]))


def test_batched_decode_matches_reference(fitted):
    """``BatchedDecoder.decode`` over several padded blocks: same seed
    from the numpy rng, per-block ``fold_in`` keys."""
    jpipe, _, pipe = fitted
    jgan, gan = jpipe.features, pipe.features
    raw = np.array(jgan._activate(jfeatures._mlp(
        jgan.params["g"], np.random.default_rng(1).standard_normal(
            (2500, jgan.cfg.d_z)).astype(np.float32),
        jax.random.PRNGKey(0), 0.0, False)))
    cj, kj = jgan.codec.batched(1024).decode(raw, np.random.default_rng(6))
    ct, kt = gan.codec.batched(1024, "cpu").decode(torch.from_numpy(raw),
                                                  np.random.default_rng(6))
    assert _row_match(cj, kj, ct, kt) >= 0.999


def test_vgm_inverse_matches_reference(fitted):
    from repro.tabular import vgm as jvgm
    from repro_torch.tabular import vgm
    jpipe, _, pipe = fitted
    rng = np.random.default_rng(2)
    for jp, tp in zip(jpipe.features.codec.vgms, pipe.features.codec.vgms):
        mode = rng.integers(0, len(jp.means), 500)
        alpha = rng.uniform(-1, 1, 500).astype(np.float32)
        np.testing.assert_array_equal(
            vgm.inverse(tp, torch.from_numpy(mode), torch.from_numpy(alpha))
            .numpy(), jvgm.inverse(jp, mode, alpha))


def test_random_aligner_matches_reference():
    from repro.core.aligner import RandomAligner as JRandomAligner
    from repro.graph.ops import Graph as JGraph
    from repro.tabular.schema import TableSchema as JSchema
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.tabular.schema import TableSchema
    src = np.arange(300, dtype=np.int32) % 17
    rng = np.random.default_rng(0)
    cont = rng.random((320, 2)).astype(np.float32)
    cat = rng.integers(0, 5, (320, 3)).astype(np.int32)
    cj, kj = JRandomAligner(JSchema(2, (5, 5, 5))).align(
        JGraph(src, src, 17, 17), cont, cat, np.random.default_rng(9))
    ct, kt = RandomAligner(TableSchema(2, (5, 5, 5))).align(
        gops.Graph(torch.from_numpy(src), torch.from_numpy(src), 17, 17),
        torch.from_numpy(cont), torch.from_numpy(cat),
        np.random.default_rng(9))
    np.testing.assert_array_equal(ct.numpy(), cj)
    np.testing.assert_array_equal(kt.numpy(), kj)
