"""The port's baseline generators against the JAX package, on the CPU.

The same inputs, made from a numpy seed, go through both packages.
Tolerances and why:

* exact — ER and SBM ids and fitted state, ``sample_erdos_renyi``, the
  KDE and Random generators' fitted state and draws,
  ``TableCodec.decode``/``decode_reference``, and a KDE + random-aligner
  dataset's shard bytes and manifest: the same numpy Generator draws in
  the same order, the same threefry words, and integer or IEEE float64
  arithmetic on the same values;
* Table 6's grid, generated by ``SyntheticGraphPipeline`` from
  components its ``fit`` fitted: ids exact for every
  structure; rows exact where neither the GAN nor the GBDT aligner is in
  the combination; otherwise the tolerances of
  ``tests/test_torch_pipeline.py`` — category ids of the GAN's draw equal
  and continuous values within 1e-5 on ≥ 99.9% of rows, aligned rows
  equal on ≥ 99% (float sums round apart from XLA's in the last ulps; a
  near-tie moves a row in rank matching).
"""
import itertools

import jax
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import features as jfeatures
from repro.core import rmat as jrmat
from repro.core.aligner import AlignerConfig as JAlignerConfig
from repro.core.aligner import RandomAligner as JRandomAligner
from repro.core.gbdt import GBDTConfig as JGBDTConfig
from repro.core.pipeline import SyntheticGraphPipeline as JPipeline
from repro.data import reference as jref
from repro.graph import ops as jgops
from repro.tabular.schema import infer_schema as jinfer_schema
from repro_torch import random as tr
from repro_torch.core import baselines, features, rmat
from repro_torch.core.aligner import AlignerConfig, RandomAligner
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.graph import ops as gops
from repro_torch.tabular.schema import infer_schema

#: the small tables of the pipeline tests
BIPARTITE = dict(n_src=256, n_dst=64, n_edges=2000)
HOMOGENEOUS = dict(n=512, n_edges=3000)
ROUNDS = 3


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _table(bipartite: bool):
    """A JAX-package table (numpy arrays) and its port ``Graph``."""
    g, cont, cat = (jref.tabformer_like(**BIPARTITE) if bipartite
                    else jref.paysim_like(**HOMOGENEOUS))
    tg = gops.Graph(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                    g.n_src, g.n_dst, g.bipartite)
    return g, tg, cont, cat


def _same_graph(got: gops.Graph, want) -> None:
    assert got.src.dtype == torch.int32 and got.dst.dtype == torch.int32
    np.testing.assert_array_equal(got.src.numpy(), np.asarray(want.src))
    np.testing.assert_array_equal(got.dst.numpy(), np.asarray(want.dst))
    assert (got.n_src, got.n_dst, got.bipartite) == \
        (want.n_src, want.n_dst, want.bipartite)


# -- structure ---------------------------------------------------------------

SCALES = [(1, True), (4, True), (4, False)]


@pytest.mark.parametrize("bipartite", [True, False])
@pytest.mark.parametrize("scale,dense", SCALES)
def test_er_ids_match_reference(bipartite, scale, dense):
    g, tg, _, _ = _table(bipartite)
    se = scale ** 2 if dense else scale
    want = jbaselines.ERGenerator().fit(g).sample(
        np.random.default_rng(7), scale, se)
    got = baselines.ERGenerator(device="cpu").fit(tg).sample(
        np.random.default_rng(7), scale, se)
    _same_graph(got, want)
    assert got.n_edges == g.n_edges * se


@pytest.mark.parametrize("mode", ["powerlaw", "empirical"])
@pytest.mark.parametrize("bipartite", [True, False])
@pytest.mark.parametrize("scale,dense", SCALES)
def test_sbm_fit_and_ids_match_reference(mode, bipartite, scale, dense):
    g, tg, _, _ = _table(bipartite)
    se = scale ** 2 if dense else scale
    jsbm = jbaselines.SBMGenerator(degree_mode=mode, seed=5).fit(g)
    sbm = baselines.SBMGenerator(degree_mode=mode, seed=5,
                                 device="cpu").fit(tg)
    for field in ("block_mass", "src_blocks", "dst_blocks", "src_deg_w",
                  "dst_deg_w"):
        a, b = getattr(sbm.fitres, field), getattr(jsbm.fitres, field)
        assert a.dtype == b.dtype, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    want = jsbm.sample(np.random.default_rng(11), scale, se)
    got = sbm.sample(np.random.default_rng(11), scale, se)
    _same_graph(got, want)
    assert sbm.last_host_s > 0


def test_choice_indices_are_numpys():
    """``rng.choice(p=...)`` as the cdf and ``rng.random`` draws with the
    bin search in torch, zero-probability bins included."""
    for seed in range(20):
        r = np.random.default_rng(seed)
        p = r.random(int(r.integers(1, 200))) ** 3
        p[r.random(len(p)) < 0.2] = 0
        p[0] += 1e-3
        p /= p.sum()
        a, b = np.random.default_rng(seed + 1), np.random.default_rng(seed + 1)
        want = a.choice(len(p), size=3001, p=p)
        got = baselines.choice_indices(
            torch.from_numpy(baselines.choice_cdf(p)), b.random(3001))
        np.testing.assert_array_equal(got.numpy(), want)
        assert a.random() == b.random()


@pytest.mark.parametrize("n_src,n_dst,n_edges", [
    (1000, 37, 5000), (3, 1 << 20, 4097), ((1 << 31) - 1, 12345, 1000),
    (1 << 20, 1 << 20, 1 << 16)])
@pytest.mark.parametrize("seed", [0, 9])
def test_sample_erdos_renyi_matches_reference(n_src, n_dst, n_edges, seed):
    _require_partitionable()
    js, jd = jrmat.sample_erdos_renyi(jax.random.PRNGKey(seed), n_src,
                                      n_dst, n_edges)
    s, d = rmat.sample_erdos_renyi(tr.PRNGKey(seed), n_src, n_dst, n_edges,
                                   device="cpu")
    assert s.dtype == torch.int32 and d.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


# -- features ----------------------------------------------------------------

def _feature_table(case: str):
    r = np.random.default_rng(3)
    n = 700
    cont = np.concatenate([r.lognormal(1.0, 1.5, (n, 1)),
                           r.normal(-2.0, 0.3, (n, 1))], 1).astype(np.float32)
    cat = np.stack([r.integers(0, 4, n), r.zipf(1.6, n) % 9,
                    np.zeros(n, np.int64)], 1).astype(np.int32)
    if case == "no_cont":
        cont = cont[:, :0]
    if case == "no_cat":
        cat = cat[:, :0]
    return cont, cat


@pytest.mark.parametrize("case,bandwidth", [
    ("both", None), ("both", 0.25), ("no_cont", None), ("no_cat", None)])
def test_kde_fit_and_draws_match_reference(case, bandwidth):
    cont, cat = _feature_table(case)
    jgen = jfeatures.KDEFeatureGenerator(jinfer_schema(cont, cat),
                                         bandwidth).fit(cont, cat)
    gen = features.KDEFeatureGenerator(infer_schema(cont, cat), bandwidth,
                                       device="cpu").fit(cont, cat, steps=9)
    assert gen.bw.dtype == jgen.bw.dtype
    np.testing.assert_array_equal(gen.bw, jgen.bw)
    np.testing.assert_array_equal(gen.cont_data, jgen.cont_data)
    assert len(gen.cat_probs) == len(jgen.cat_probs)
    for a, b in zip(gen.cat_probs, jgen.cat_probs):
        np.testing.assert_array_equal(a, b)
    for n in (5000, 0):
        jc, jk = jgen.sample(np.random.default_rng(21), n)
        c, k = gen.sample(np.random.default_rng(21), n)
        assert c.dtype == torch.float32 and k.dtype == torch.int32
        assert tuple(c.shape) == jc.shape and tuple(k.shape) == jk.shape
        np.testing.assert_array_equal(c.numpy().view(np.int32),
                                      jc.view(np.int32))
        np.testing.assert_array_equal(k.numpy(), jk)


@pytest.mark.parametrize("case", ["both", "no_cont", "no_cat"])
def test_random_fit_and_draws_match_reference(case):
    cont, cat = _feature_table(case)
    jgen = jfeatures.RandomFeatureGenerator(jinfer_schema(cont, cat)).fit(
        cont, cat)
    gen = features.RandomFeatureGenerator(infer_schema(cont, cat),
                                          device="cpu").fit(cont, cat)
    np.testing.assert_array_equal(gen.lo, jgen.lo)
    np.testing.assert_array_equal(gen.hi, jgen.hi)
    jc, jk = jgen.sample(np.random.default_rng(4), 3000)
    c, k = gen.sample(np.random.default_rng(4), 3000)
    assert c.dtype == torch.float32 and k.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy().view(np.int32), jc.view(np.int32))
    np.testing.assert_array_equal(k.numpy(), jk)


def test_feature_registry_matches_reference():
    assert set(features.FEATURE_GENERATORS) == \
        set(jfeatures.FEATURE_GENERATORS)
    for gen in (features.KDEFeatureGenerator,
                features.RandomFeatureGenerator):
        assert gen.engine_batched is False
        assert not hasattr(gen, "stream_marker")


def _activated_raw(codec, n: int, seed: int) -> np.ndarray:
    """Activated generator output: α in [-1.2, 1.2] (the decode clips
    it), softmax probabilities per mode and category group."""
    r = np.random.default_rng(seed)
    parts = []

    def softmax(k):
        x = np.exp(r.normal(0, 2, (n, k)))
        return x / x.sum(1, keepdims=True)

    for _ in range(codec.schema.n_cont):
        parts += [r.uniform(-1.2, 1.2, (n, 1)), softmax(codec.n_modes)]
    for card in codec.schema.cat_cards:
        parts.append(softmax(card))
    return np.concatenate(parts, 1).astype(np.float32)


@pytest.mark.parametrize("method", ["decode", "decode_reference"])
@pytest.mark.parametrize("n_modes", [5, 3])
def test_codec_decode_matches_reference(method, n_modes):
    cont, cat = _feature_table("both")
    jcodec = jfeatures.TableCodec(jinfer_schema(cont, cat), n_modes).fit(
        cont, cat)
    codec = features.TableCodec(infer_schema(cont, cat), n_modes).fit(
        cont, cat)
    assert codec.cont_widths == jcodec.cont_widths
    assert codec.enc_dim == jcodec.enc_dim
    raw = _activated_raw(codec, 1500, seed=n_modes)
    jc, jk = getattr(jcodec, method)(raw, np.random.default_rng(8))
    c, k = getattr(codec, method)(raw, np.random.default_rng(8))
    assert c.dtype == jc.dtype and k.dtype == jk.dtype
    np.testing.assert_array_equal(c.view(np.int32), jc.view(np.int32))
    np.testing.assert_array_equal(k, jk)


# -- Table 6's grid through the pipeline -------------------------------------

GRID = list(itertools.product(["kronecker", "sbm", "er"],
                              ["gan", "kde", "random"],
                              ["xgboost", "random"]))


def _row_match(c1, k1, c2, k2) -> float:
    same_cat = (np.asarray(k1) == np.asarray(k2)).all(1)
    same_cont = np.isclose(np.asarray(c1), np.asarray(c2), rtol=1e-5,
                           atol=1e-5).all(1)
    return float((same_cat & same_cont).mean())


def _pipelines(struct, feats, aligner, feature_kind="edge"):
    kw = dict(struct=struct, features=feats, aligner=aligner, noise=0.03,
              gan_steps=2, feature_kind=feature_kind)
    return (JPipeline(aligner_cfg=JAlignerConfig(
                gbdt=JGBDTConfig(n_rounds=ROUNDS)), **kw),
            SyntheticGraphPipeline(aligner_cfg=AlignerConfig(
                gbdt=GBDTConfig(n_rounds=ROUNDS)), device="cpu", **kw))


#: three fits that between them fit every structure, feature generator
#: and aligner once
FITS = [("kronecker", "gan", "xgboost"), ("sbm", "kde", "random"),
        ("er", "random", "random")]


@pytest.fixture(scope="module")
def grid_parts():
    """Each package's components, fitted by ``SyntheticGraphPipeline.fit``
    on the bipartite table (the three fits of ``FITS``).  A pipeline's fit
    is its components' fits, each independent of the others, so a
    pipeline composed from them is the one its own ``fit`` gives: the
    grid composes them, as ``benchmarks/table6_ablation.py`` does (the
    port's by ``SyntheticGraphPipeline.fitted``)."""
    _require_partitionable()
    g, tg, cont, cat = _table(True)
    parts = {"jax": {}, "port": {}}
    for combo in FITS:
        jpipe, pipe = _pipelines(*combo)
        jpipe.fit(g, cont, cat)
        pipe.fit(tg, cont, cat)
        for name, p in (("jax", jpipe), ("port", pipe)):
            parts[name].setdefault("struct", {})[combo[0]] = p.struct
            parts[name].setdefault("features", {})[combo[1]] = p.features
            parts[name].setdefault("aligner", {}).setdefault(combo[2],
                                                              p.aligner)
            parts[name]["last"] = p
    return parts


def _composed(parts, struct, feats, aligner):
    """The JAX pipeline composed by hand, the port's by ``fitted``."""
    jparts, tparts = parts["jax"], parts["port"]
    jpipe = JPipeline(struct=struct, features=feats, aligner=aligner)
    jpipe.struct = jparts["struct"][struct]
    jpipe.features = jparts["features"][feats]
    jpipe.aligner = jparts["aligner"][aligner]
    jpipe.schema, jpipe._g_ref = jparts["last"].schema, jparts["last"]._g_ref
    pipe = SyntheticGraphPipeline.fitted(
        tparts["struct"][struct], tparts["features"][feats],
        tparts["aligner"][aligner], tparts["last"].bipartite, device="cpu")
    assert (pipe.struct_kind, pipe.feat_kind) == (struct, feats)
    return jpipe, pipe


@pytest.mark.parametrize("struct,feats,aligner", GRID)
def test_table6_grid_matches_reference(grid_parts, struct, feats, aligner):
    jpipe, pipe = _composed(grid_parts, struct, feats, aligner)
    g1, c1, k1 = jpipe.generate(seed=3, scale_nodes=2)
    g2, c2, k2 = pipe.generate(seed=3, scale_nodes=2)
    _same_graph(g2, g1)
    assert c2.dtype == torch.float32 and k2.dtype == torch.int32
    assert tuple(c2.shape) == c1.shape and tuple(k2.shape) == k1.shape
    if feats != "gan" and aligner == "random":
        np.testing.assert_array_equal(c2.numpy().view(np.int32),
                                      np.asarray(c1).view(np.int32))
        np.testing.assert_array_equal(k2.numpy(), np.asarray(k1))
    else:
        assert _row_match(c1, k1, c2, k2) >= 0.99
    if feats != "gan":
        # the unaligned draw itself is the reference's bytes
        jc, jk = jpipe.features.sample(np.random.default_rng(5), 777)
        c, k = pipe.features.sample(np.random.default_rng(5), 777)
        np.testing.assert_array_equal(c.numpy().view(np.int32),
                                      jc.view(np.int32))
        np.testing.assert_array_equal(k.numpy(), jk)
    assert pipe.timings.gen_struct_s > 0 and pipe.timings.gen_feat_s > 0


def test_node_feature_kde_gbdt_matches_reference():
    """Kronecker + KDE + GBDT on node features, as
    ``examples/pretrain_finetune_gnn.py`` composes it."""
    _require_partitionable()
    g, cont, cat = jref.cora_like(n=512, n_edges=2000)
    tg = gops.Graph(torch.from_numpy(g.src), torch.from_numpy(g.dst),
                    g.n_src, g.n_dst, g.bipartite)
    jpipe, pipe = _pipelines("kronecker", "kde", "xgboost", "node")
    jpipe.fit(g, cont, cat)
    pipe.fit(tg, cont, cat)
    g1, c1, k1 = jpipe.generate(seed=0)
    g2, c2, k2 = pipe.generate(seed=0)
    _same_graph(g2, g1)
    assert c2.shape[0] == g2.n_nodes
    assert _row_match(c1, k1, c2, k2) >= 0.99


# -- a KDE + random-aligner dataset ------------------------------------------

def test_kde_random_aligner_dataset_matches_reference(tmp_path):
    """Both packages' ``DatasetJob`` with a KDE + ``RandomAligner``
    ``FeatureSpec``: every shard file and the manifest byte for byte; the
    manifest's ``features`` pins no batch, device or stream.  A shard
    deleted and resumed comes back the same."""
    _require_partitionable()
    import hashlib
    import os
    from repro.core.structure import KroneckerFit as JFit
    from repro.datastream import DatasetJob as JJob
    from repro.datastream import FeatureSpec as JSpec
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream import DatasetJob, FeatureSpec, Manifest

    cont, cat = _feature_table("both")
    fit = dict(a=0.45, b=0.22, c=0.2, d=0.13, n=12, m=12, E=30_000)
    jspec = JSpec(jfeatures.KDEFeatureGenerator(
        jinfer_schema(cont, cat)).fit(cont, cat),
        JRandomAligner(jinfer_schema(cont, cat)))
    schema = infer_schema(cont, cat)
    spec = FeatureSpec(features.KDEFeatureGenerator(
        schema, device="cpu").fit(cont, cat), RandomAligner(schema))
    jout, out = str(tmp_path / "jax"), str(tmp_path / "port")
    kw = dict(shard_edges=8192, seed=2, k_pref=1)
    JJob(JFit(**fit), jout, features=jspec, backend="xla", **kw).run()
    job = lambda: DatasetJob(KroneckerFit(**fit), out,  # noqa: E731
                             features=spec, backend="reference",
                             device="cpu", **kw)
    job().run()

    def hashes(path):
        return {f: hashlib.md5(open(os.path.join(path, f), "rb").read())
                .hexdigest() for f in sorted(os.listdir(path))
                if f.endswith(".npy") or f == "manifest.json"}

    want = hashes(jout)
    assert hashes(out) == want
    m = Manifest.load(out)
    assert m.features == {"n_cont": 2, "cat_cards": list(schema.cat_cards)}
    assert len(m.shards) > 2
    os.remove(os.path.join(out, m.shards[1].files["cont"]))
    job().resume()
    assert hashes(out) == want
