"""The port's fit path against the JAX package.

Both packages fit the same small table (``tabformer_like(n_src=256,
n_dst=64, n_edges=2000)``, ``gan_steps=10``, ``GBDTConfig(n_rounds=10)``).
Tolerances and why:

* exact — ``tabformer_like``'s arrays, ``BitPairMLE`` counts (int32 ids
  and int64 ids past 2^31), ``estimate_ratios_mle``,
  ``fit_marginals_hist``, ``candidate_fits``, ``fit_structure``,
  ``degree_dist_similarity``, VGMs, ``transform``, ``infer_schema``,
  ``TableCodec.encode``, ``random.bernoulli``, and the GBDT's trees and
  bin packs given the reference's own X: integer counts, then the same
  numpy/scipy code on the same inputs;
* the GAN's initial weights: exact when both packages draw the same
  normals (the keys, splits, shapes and scales are the reference's);
  with the port's own ``random.normal`` within 1e-6, because that is
  within one float32 ulp of ``jax.random.normal`` (XLA's CPU ``log``
  inside erfinv rounds differently from torch's, ``test_torch_random``);
* the GAN's weights after 1, 3 and 10 training steps: 1e-6 absolute,
  and the step-0 losses 1e-6 — float32 matmul and
  batch-norm reductions, autograd's gradient sums and ``pow`` round apart
  from XLA's in the last ulp, and Adam's first steps (≈ ±lr·sign g)
  carry that along without growing it much;
* the losses recorded at steps 0, 50 and 100: 1e-2 absolute — over a
  hundred steps the ulp differences are amplified by
  the adversarial dynamics, so a longer fit is held by what it produces
  (``chip_smoke.py``), not by its weights;
* the aligner's ``col_quality`` from the port's own X: 0.02 absolute —
  PageRank/Katz features differ from the
  reference's by float32 summation order, which can move a quantile bin
  edge by an ulp and so a split.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import features as jfeatures
from repro.core import fit_engine as jfit_engine
from repro.core import metrics as jmetrics
from repro.core import structure as jstructure
from repro.core.aligner import AlignerConfig as JAlignerConfig
from repro.core.aligner import GBDTAligner as JGBDTAligner
from repro.core.gbdt import GBDTClassifier as JGBDTClassifier
from repro.core.gbdt import GBDTConfig as JGBDTConfig
from repro.core.gbdt import GBDTRegressor as JGBDTRegressor
from repro.core.pipeline import SyntheticGraphPipeline as JPipeline
from repro.data.reference import tabformer_like as jtabformer_like
from repro.graph import ops as jgops
from repro.tabular import schema as jschema
from repro.tabular import vgm as jvgm
from repro_torch import convert, random as tr
from repro_torch.core import features, fit_engine, metrics, structure
from repro_torch.core.aligner import AlignerConfig, GBDTAligner
from repro_torch.core.gbdt import GBDTClassifier, GBDTConfig, GBDTRegressor
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data.reference import tabformer_like
from repro_torch.graph import ops as gops
from repro_torch.tabular import schema, vgm

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(n_src=256, n_dst=64, n_edges=2000)


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _export_module():
    spec = importlib.util.spec_from_file_location(
        "export_torch_state", ROOT / "scripts" / "export_torch_state.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def table():
    """The small table in both packages' forms."""
    return jtabformer_like(**SMALL), tabformer_like(**SMALL)


@pytest.fixture(scope="module")
def fitted(table):
    """One whole fit per package."""
    _require_partitionable()
    (g, cont, cat), (tg, _, _) = table
    jpipe = JPipeline(noise=0.03, gan_steps=10, aligner_cfg=JAlignerConfig(
        gbdt=JGBDTConfig(n_rounds=10)))
    jpipe.fit(g, cont, cat)
    pipe = SyntheticGraphPipeline(
        noise=0.03, gan_steps=10,
        aligner_cfg=AlignerConfig(gbdt=GBDTConfig(n_rounds=10)),
        device="cpu").fit(tg, cont, cat)
    return jpipe, pipe


# ---------------------------------------------------------------------------
# input table and structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [dict(seed=0, **SMALL), dict(seed=3)])
def test_tabformer_like_matches_reference(kw):
    g, cont, cat = jtabformer_like(**kw)
    tg, tcont, tcat = tabformer_like(**kw)
    np.testing.assert_array_equal(tg.src.numpy(), g.src)
    np.testing.assert_array_equal(tg.dst.numpy(), g.dst)
    assert (tg.n_src, tg.n_dst, tg.bipartite) == (g.n_src, g.n_dst,
                                                  g.bipartite)
    assert tg.src.dtype == torch.int32
    np.testing.assert_array_equal(tcont, cont)
    np.testing.assert_array_equal(tcat, cat)
    assert tcont.dtype == cont.dtype and tcat.dtype == cat.dtype


@pytest.mark.parametrize("n,m,wide,block", [
    (8, 6, False, 1 << 20),        # int32 ids, one block
    (12, 9, False, 777),           # int32 ids, ragged blocks
    (40, 36, True, 1 << 20),       # int64 ids above 2^31: hi words live
    (33, 31, True, 1000),          # wide ids across the word boundary
])
def test_bitpair_counts_exact(n, m, wide, block):
    rng = np.random.default_rng(n * 100 + m)
    dt = np.int64 if wide else np.int32
    src = rng.integers(0, 2 ** n, 5000, dtype=np.int64).astype(dt)
    dst = rng.integers(0, 2 ** m, 5000, dtype=np.int64).astype(dt)
    want = jfit_engine.BitPairMLE(n, m, block=block).update(src, dst)
    got = fit_engine.BitPairMLE(n, m, block=block).update(
        torch.from_numpy(src), torch.from_numpy(dst))
    np.testing.assert_array_equal(got.counts, want.counts)
    assert got.rows == want.rows == 5000
    np.testing.assert_array_equal(got.ratios(), want.ratios())


def test_ratios_and_marginals_exact(table):
    (g, _, _), (tg, _, _) = table
    n, m = 8, 6
    want = jstructure.estimate_ratios_mle(g.src, g.dst, n, m)
    got = structure.estimate_ratios_mle(tg.src, tg.dst, n, m)
    np.testing.assert_array_equal(got, want)
    for anchor in (None, (float(want[0] + want[1]),
                          float(want[0] + want[2]))):
        assert structure.fit_marginals(tg, n, m, anchor=anchor) == \
            jstructure.fit_marginals(g, n, m, anchor=anchor)
    obs_out = np.asarray(jgops.degree_histogram(jgops.out_degrees(g), 2048))
    obs_in = np.asarray(jgops.degree_histogram(jgops.in_degrees(g), 2048))
    np.testing.assert_array_equal(
        gops.degree_histogram(gops.out_degrees(tg), 2048).numpy(), obs_out)
    np.testing.assert_array_equal(
        gops.degree_histogram(gops.in_degrees(tg), 2048).numpy(), obs_in)
    assert structure.fit_marginals_hist(obs_out, obs_in, 2000, n, m) == \
        jstructure.fit_marginals_hist(obs_out, obs_in, 2000, n, m)


def test_candidate_fits_exact(table):
    (g, _, _), (tg, _, _) = table
    n, m = 8, 6
    ratios = jstructure.estimate_ratios_mle(g.src, g.dst, n, m)
    want = jstructure.candidate_fits(
        n, m, 2000, True, 0.03, ratios,
        lambda a: jstructure.fit_marginals(g, n, m, anchor=a))
    got = structure.candidate_fits(
        n, m, 2000, True, 0.03, ratios,
        lambda a: structure.fit_marginals(tg, n, m, anchor=a))
    assert [name for name, _ in got] == [name for name, _ in want]
    assert [dataclasses.asdict(f) for _, f in got] == \
        [dataclasses.asdict(f) for _, f in want]


@pytest.mark.parametrize("noise,calibrate", [(0.03, True), (0.0, False)])
def test_fit_structure_exact(table, noise, calibrate):
    _require_partitionable()
    (g, _, _), (tg, _, _) = table
    want = jstructure.fit_structure(g, noise=noise, calibrate=calibrate)
    got = structure.fit_structure(tg, noise=noise, calibrate=calibrate)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", [1, 2])
def test_degree_dist_similarity_exact(table, seed):
    (g, _, _), (tg, _, _) = table
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, 3000).astype(np.int32)
    dst = rng.integers(0, 64, 3000).astype(np.int32)
    want = jmetrics.degree_dist_similarity(
        g, jgops.Graph(src, dst, 256, 64, True))
    got = metrics.degree_dist_similarity(
        tg, gops.Graph(torch.from_numpy(src), torch.from_numpy(dst), 256, 64,
                       True))
    assert got == want


# ---------------------------------------------------------------------------
# codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("col,n_modes", [(0, 5), (1, 5), (1, 3)])
def test_vgm_fit_and_transform_exact(table, col, n_modes):
    (_, cont, _), _ = table
    want = jvgm.fit_vgm(cont[:, col], n_modes, seed=col)
    got = vgm.fit_vgm(cont[:, col], n_modes, seed=col)
    for f in ("weights", "means", "stds", "active"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    x = np.random.default_rng(col).normal(3, 2, 777).astype(np.float32)
    for a, b in zip(vgm.transform(got, x), jvgm.transform(want, x)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_schema_and_codec_encode_exact(table):
    (_, cont, cat), _ = table
    want = jschema.infer_schema(cont, cat)
    got = schema.infer_schema(cont, cat)
    assert (got.n_cont, got.cat_cards) == (want.n_cont, want.cat_cards)
    jc = jfeatures.TableCodec(want).fit(cont, cat)
    tc = features.TableCodec(got).fit(cont, cat)
    enc = tc.encode(cont, cat)
    np.testing.assert_array_equal(enc, jc.encode(cont, cat))
    assert enc.dtype == np.float32 and enc.shape[1] == tc.enc_dim


# ---------------------------------------------------------------------------
# GAN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("p,shape", [(0.9, (256, 32)), (0.5, (3, 1001)),
                                     (0.1, (64, 35))])
@pytest.mark.parametrize("seed", [0, 11])
def test_bernoulli_matches_jax(p, shape, seed):
    _require_partitionable()
    want = np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed), p,
                                           shape))
    got = tr.bernoulli(tr.PRNGKey(seed), p, shape).numpy()
    np.testing.assert_array_equal(got, want)


def _jax_leaves(p):
    out = [p["in"]["w"], p["in"]["b"]]
    for b in p["blocks"]:
        out += [b["bn"]["scale"], b["bn"]["bias"], b["fc"]["w"], b["fc"]["b"]]
    return [np.asarray(x) for x in out + [p["out"]["w"], p["out"]["b"]]]


def _torch_leaves(mlp):
    out = [mlp.inp.w, mlp.inp.b]
    for b in mlp.blocks:
        out += [b.bn.scale, b.bn.bias, b.fc.w, b.fc.b]
    return [x.detach().numpy() for x in out + [mlp.out.w, mlp.out.b]]


def _jax_normal(key, shape, device=None):
    k = jnp.asarray(key.numpy().astype(np.uint32))
    return torch.from_numpy(np.array(jax.random.normal(k, tuple(shape))))


@pytest.mark.parametrize("normal", ["jax", "port"])
@pytest.mark.parametrize("which", ["g", "d"])
def test_gan_initial_weights(table, monkeypatch, normal, which):
    """The fit's keys, ``_mlp_init``'s splits, shapes and scales; bit for
    bit when both draw the same normals."""
    _require_partitionable()
    (_, cont, cat), _ = table
    denc = features.TableCodec(schema.infer_schema(cont, cat)).enc_dim
    kg, kd, _ = jax.random.split(jax.random.PRNGKey(0), 3)
    tkg, tkd, _ = tr.split(tr.PRNGKey(0), 3)
    args = (64, max(denc, 32), 2, denc) if which == "g" else \
        (denc, max(denc, 32), 2, 1)
    want = _jax_leaves(jfeatures._mlp_init(kg if which == "g" else kd,
                                           *args))
    if normal == "jax":
        monkeypatch.setattr(features.trandom, "normal", _jax_normal)
    got = _torch_leaves(features._mlp_init(tkg if which == "g" else tkd,
                                           *args, "cpu"))
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        if normal == "jax":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("steps", [1, 3, 10])
def test_gan_first_steps_close(table, steps):
    _require_partitionable()
    (_, cont, cat), _ = table
    jg = jfeatures.GANFeatureGenerator(jschema.infer_schema(cont, cat)).fit(
        cont, cat, steps=steps)
    tg = features.GANFeatureGenerator(schema.infer_schema(cont, cat),
                                      device="cpu").fit(cont, cat,
                                                        steps=steps)
    for got, want in ((tg.generator, jg.params["g"]),
                      (tg.discriminator, jg.params["d"])):
        for a, b in zip(_torch_leaves(got), _jax_leaves(want)):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg._losses, jg._losses, rtol=0, atol=1e-6)


def test_gan_recorded_losses_close(table):
    """Steps 0, 50 and 100 of a 101-step fit."""
    _require_partitionable()
    (_, cont, cat), _ = table
    jg = jfeatures.GANFeatureGenerator(jschema.infer_schema(cont, cat)).fit(
        cont, cat, steps=101)
    tg = features.GANFeatureGenerator(schema.infer_schema(cont, cat),
                                      device="cpu").fit(cont, cat, steps=101)
    assert len(tg._losses) == len(jg._losses) == 3
    np.testing.assert_allclose(tg._losses, jg._losses, rtol=0, atol=1e-2)
    assert np.isfinite(tg._losses).all()


# ---------------------------------------------------------------------------
# GBDT and aligner
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_inputs(table):
    """The reference aligner's X and the table."""
    (g, cont, cat), _ = table
    X = np.asarray(JGBDTAligner(jschema.infer_schema(cont, cat))._inputs(g),
                   np.float32)
    return X, cont, cat


def _same_trees(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        for f in ("feature", "threshold", "leaf", "is_leaf"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("col", [0, 1])
def test_gbdt_regressor_fit_exact(ref_inputs, col):
    """Given the reference's X: the same trees and the same bin pack."""
    X, cont, _ = ref_inputs
    want = JGBDTRegressor(JGBDTConfig(n_rounds=10)).fit(X, cont[:, col])
    got = GBDTRegressor(GBDTConfig(n_rounds=10), device="cpu").fit(
        X, cont[:, col])
    _same_trees(got.trees, want.trees)
    pk = got.packed
    for k in ("E", "code", "leaf_bot"):
        np.testing.assert_array_equal(getattr(pk, k).numpy(),
                                      np.asarray(want._binned[k]))
    assert pk.base.item() == np.float32(want.base)
    assert (pk.lr, pk.depth) == (float(np.float32(0.1)), 5)


@pytest.mark.parametrize("col", [0, 1, 2])
def test_gbdt_classifier_fit_exact(ref_inputs, col):
    X, _, cat = ref_inputs
    card = int(cat[:, col].max()) + 1
    want = JGBDTClassifier(card, JGBDTConfig(n_rounds=10)).fit(X, cat[:, col])
    got = GBDTClassifier(card, GBDTConfig(n_rounds=10), device="cpu").fit(
        X, cat[:, col])
    for gm, wm in zip(got.models, want.models):
        _same_trees(gm.trees, wm.trees)
    pk = got.packed
    for k in ("E", "code", "leaf_bot"):
        np.testing.assert_array_equal(getattr(pk, k).numpy(),
                                      np.asarray(want._binned[k]))
    np.testing.assert_array_equal(pk.base.numpy(), np.asarray(want._base))
    np.testing.assert_array_equal(got.predict(torch.from_numpy(X)).numpy(),
                                  np.asarray(want.predict(X)))


def test_aligner_col_quality_close(table):
    """From each package's own X; forests shaped as the reference's."""
    (g, cont, cat), (tg, _, _) = table
    want = JGBDTAligner(jschema.infer_schema(cont, cat), JAlignerConfig(
        gbdt=JGBDTConfig(n_rounds=10))).fit(g, cont, cat)
    got = GBDTAligner(schema.infer_schema(cont, cat), AlignerConfig(
        gbdt=GBDTConfig(n_rounds=10))).fit(tg, cont, cat)
    assert len(got.col_quality) == len(want.col_quality)
    np.testing.assert_allclose(got.col_quality, want.col_quality, rtol=0,
                               atol=0.02)
    assert [m is None for m in got.cat_models] == \
        [m is None for m in want.cat_models]
    for gm, wm in zip(got.cont_models, want.cont_models):
        assert tuple(gm.packed.code.shape) == np.asarray(
            wm._binned["code"]).shape


def test_aligner_no_holdout_rule():
    """Tiny inputs leave no holdout row: every quality is 0.5."""
    g = gops.Graph(torch.tensor([0, 1, 0, 1]), torch.tensor([0, 0, 1, 1]),
                   2, 2, True)
    cont = np.arange(4, dtype=np.float32)[:, None]
    cat = np.array([[0], [1], [0], [1]], np.int32)
    al = GBDTAligner(schema.infer_schema(cont[:1], cat[:1]),
                     AlignerConfig(gbdt=GBDTConfig(n_rounds=2)))
    al.fit(g, cont[:1], cat[:1])
    assert al.col_quality == [0.5, 0.5]


# ---------------------------------------------------------------------------
# the whole fit
# ---------------------------------------------------------------------------

def test_whole_fit_state_matches_reference(fitted):
    jpipe, pipe = fitted
    want = _export_module().state_from_jax_pipeline(jpipe)
    got = convert.state_from_pipeline(pipe)
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.startswith(("struct/", "gan/vgm/", "schema/", "pipe/")):
            np.testing.assert_array_equal(a, b, err_msg=k)
    assert pipe.timings.fit_struct_s > 0 and pipe.timings.fit_align_s > 0
    assert np.isfinite(pipe.features._losses).all()


@pytest.mark.parametrize("kw", [dict(struct="sbm"), dict(struct="er"),
                                dict(features="kde"),
                                dict(features="random")])
def test_fit_of_unported_components_raises(table, kw):
    """The baseline components, which the port's fit once refused, fit as
    the JAX package's do: the component's state equal, and ``generate``
    from one seed gives the reference's ids and rows byte for byte (the
    other components random, so no GAN or GBDT float sums enter)."""
    _require_partitionable()
    (g, jcont, jcat), (tg, cont, cat) = table
    kw = dict(dict(features="random", aligner="random", noise=0.03), **kw)
    jpipe = JPipeline(**kw).fit(g, jcont, jcat)
    pipe = SyntheticGraphPipeline(device="cpu", **kw).fit(tg, cont, cat)
    if kw.get("struct") == "sbm":
        for f in ("block_mass", "src_blocks", "dst_blocks", "src_deg_w",
                  "dst_deg_w"):
            np.testing.assert_array_equal(getattr(pipe.struct.fitres, f),
                                          getattr(jpipe.struct.fitres, f))
    elif kw.get("struct") == "er":
        assert (pipe.struct.n_src, pipe.struct.n_dst, pipe.struct.E,
                pipe.struct.bipartite) == (jpipe.struct.n_src,
                                           jpipe.struct.n_dst, jpipe.struct.E,
                                           jpipe.struct.bipartite)
    else:
        assert dataclasses.asdict(pipe.struct) == \
            dataclasses.asdict(jpipe.struct)
    if kw["features"] == "kde":
        np.testing.assert_array_equal(pipe.features.bw, jpipe.features.bw)
        for a, b in zip(pipe.features.cat_probs, jpipe.features.cat_probs):
            np.testing.assert_array_equal(a, b)
    else:
        np.testing.assert_array_equal(pipe.features.lo, jpipe.features.lo)
        np.testing.assert_array_equal(pipe.features.hi, jpipe.features.hi)
    g1, c1, k1 = jpipe.generate(seed=2, scale_nodes=2)
    g2, c2, k2 = pipe.generate(seed=2, scale_nodes=2)
    np.testing.assert_array_equal(g2.src.numpy(), np.asarray(g1.src))
    np.testing.assert_array_equal(g2.dst.numpy(), np.asarray(g1.dst))
    np.testing.assert_array_equal(c2.numpy().view(np.int32),
                                  np.asarray(c1).view(np.int32))
    np.testing.assert_array_equal(k2.numpy(), np.asarray(k1))
    with pytest.raises(ValueError, match="kronecker"):
        convert.state_from_pipeline(pipe)


def test_random_aligner_fit_generates(table):
    _, (tg, cont, cat) = table
    pipe = SyntheticGraphPipeline(aligner="random", gan_steps=2,
                                  device="cpu").fit(tg, cont, cat)
    state = convert.state_from_pipeline(pipe)
    assert str(state["aligner/kind"]) == "random"
    g, c, k = convert.pipeline_from_state(state, "cpu").generate(seed=1)
    assert g.n_edges == pipe.struct.E and c.shape == (g.n_edges, 2)
    assert torch.isfinite(c).all()
