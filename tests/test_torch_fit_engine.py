"""The port's streaming fit engine against the JAX package's, on the CPU.

Inputs come from a seed through numpy, or from datasets the port's
``DatasetJob`` writes (``reference`` stream, which is the JAX package's
``xla`` stream) and both packages read.  Everything is held exactly:

* ``graph.ops.sparse_degree_histogram``, ``metrics.degree_counts_
  similarity``: integer counts, then the reference's numpy arithmetic;
* each accumulator — ``DegreeSketch`` dense, bucketed and over a 2^34 id
  space, ``ReservoirSample`` uniform and stratified (rows, columns,
  provenance), ``Moments`` (fsum, to the last bit), ``CatCards`` — fed
  the same chunks, the port's in reverse order;
* the reservoir's device hash: ``_mix64`` in int64 arithmetic equals
  numpy's uint64 ``_mix64`` on every bit pattern, ids ≥ 2^63 included,
  and sorting the bit-63-flipped priorities as int64 is their uint64
  order;
* ``accumulate`` over one dataset directory read by both packages, field
  by field, and ``fit_to_json`` byte for byte: int32 and int64 ids, ids
  past 2^31 (the bucketed sketch), struct only and with features, in
  the manifest's shard order and reversed;
* the structure fit at the main path's density: the stats of the
  scale-64 dataset (``fixtures/refit64.json`` and ``refit64_hists.npz``,
  written on the card by ``fixtures/make_refit64.py``) through each
  package's ``fit_structure_streamed`` give the card's fit JSON back.

The card's counterpart of these checks is in ``tests/test_torch_cuda.py``.
"""
import dataclasses
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import fit_engine as jfe
from repro.core import metrics as jmetrics
from repro.datastream.fitsource import DatasetFitSource as JDatasetFitSource
from repro.graph import ops as jops
from repro_torch.core import fit_engine as fe
from repro_torch.core import metrics
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (ArrayFitSource, DatasetFitSource,
                                    DatasetJob, ShardedGraphDataset)
from repro_torch.graph import ops

THETA = dict(a=0.45, b=0.22, c=0.2, d=0.13)
#: the JAX fit-engine tests' fit, cut to 2^12 nodes a side
FIT = dict(THETA, n=12, m=12, E=40_000)
#: ids past 31 bits: (hi, lo) words, the bucketed degree sketch
WIDE = dict(THETA, n=33, m=32, E=6_000)
FIXTURES = Path(__file__).resolve().parent / "fixtures"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the calibration samples are thousands of small
    torch ops, whose thread pool stalls when test workers share the cores
    (20 s against 0.07 s for one 40 000-edge sample with 8 busy cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _write(path, fit, shard_edges=12_000, **kw):
    DatasetJob(KroneckerFit(**fit), str(path), shard_edges=shard_edges,
               seed=0, backend="reference", device="cpu", **kw).run()
    return str(path)


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """Struct-only datasets written by the port on the CPU: int32 ids,
    the same graph with int64 ids, and a wide id space."""
    _require_partitionable()
    root = tmp_path_factory.mktemp("fitds")
    return {"int32": _write(root / "i32", FIT),
            "int64": _write(root / "i64", FIT, id_dtype="int64"),
            "wide": _write(root / "wide", WIDE, shard_edges=2_500)}


@pytest.fixture(scope="module")
def featured(tmp_path_factory):
    """A dataset with 2 cont + 1 cat feature columns: a port GAN trained
    two steps on a seeded table draws them, a random aligner places
    them."""
    _require_partitionable()
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.features import GANFeatureGenerator
    from repro_torch.datastream import FeatureSpec
    from repro_torch.tabular.schema import infer_schema
    rng = np.random.default_rng(5)
    cont = rng.normal(size=(300, 2)).astype(np.float32)
    cat = rng.integers(0, 3, size=(300, 1)).astype(np.int32)
    schema = infer_schema(cont, cat)
    gen = GANFeatureGenerator(schema, device="cpu").fit(cont, cat, steps=2)
    spec = FeatureSpec(gen, RandomAligner(schema))
    return _write(tmp_path_factory.mktemp("featds") / "ds",
                  dict(FIT, E=20_000), features=spec)


def _chunks(mod, src, dst, cont, cat, sizes):
    out, off = [], 0
    for s in sizes:
        out.append(mod.FitChunk(
            src[off:off + s], dst[off:off + s],
            None if cont is None else cont[off:off + s],
            None if cat is None else cat[off:off + s], start_row=off))
        off += s
    return out


# -- graph.ops / metrics ------------------------------------------------------

@pytest.mark.parametrize("bits,kmax", [(9, 8), (34, 128)])
def test_sparse_degree_histogram_matches_reference(bits, kmax):
    rng = np.random.default_rng(bits)
    ids = rng.integers(0, 1 << bits, 20_000).astype(
        np.int64 if bits > 31 else np.int32)
    ids[:300] = ids[0]                       # one heavy node
    want = jops.sparse_degree_histogram(ids, 1 << bits, kmax)
    got = ops.sparse_degree_histogram(torch.from_numpy(ids), 1 << bits, kmax)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == np.int64 and got[1] == want[1] >= 300
    empty = ops.sparse_degree_histogram(np.zeros(0, np.int32), 16, 4)
    assert empty[1] == 0 and empty[0].tolist() == [16, 0, 0, 0, 0]


def test_degree_counts_similarity_matches_reference():
    rng = np.random.default_rng(1)
    hists = [rng.integers(0, 50, 65) for _ in range(4)]
    maxes = [64, 300, 17, 2]
    for h, mx in zip(hists, maxes):
        np.testing.assert_array_equal(
            metrics._normalized_log_hist_counts(h, mx),
            jmetrics._normalized_log_hist_counts(h, mx))
    args = [x for pair in zip(hists, maxes) for x in pair]
    assert metrics.degree_counts_similarity(*args) == \
        jmetrics.degree_counts_similarity(*args)
    assert metrics.degree_counts_similarity(
        np.zeros(5), 0, hists[0], 0, hists[1], 9, hists[2], 0) == \
        jmetrics.degree_counts_similarity(
            np.zeros(5), 0, hists[0], 0, hists[1], 9, hists[2], 0)


# -- accumulators -------------------------------------------------------------

@pytest.mark.parametrize("case", ["dense", "bucketed", "wide"])
def test_degree_sketch_matches_reference(case):
    rng = np.random.default_rng(2)
    if case == "wide":
        n_nodes, kmax, limit = 1 << 34, 128, fe.DENSE_NODE_LIMIT
        ids = rng.integers(0, n_nodes, 5_000).astype(np.int64)
        ids[:100] = ids[0]
    else:
        n_nodes, kmax = 10_000, 64
        limit = 257 if case == "bucketed" else fe.DENSE_NODE_LIMIT
        ids = rng.integers(0, n_nodes, 50_000).astype(np.int32)
    parts = np.split(ids, [1, len(ids) // 3])
    want = jfe.DegreeSketch(n_nodes, kmax, limit)
    got = fe.DegreeSketch(n_nodes, kmax, limit, device="cpu")
    for p in parts:
        want.update(p)
    for p in parts[::-1]:
        got.update(torch.from_numpy(p))
    assert got.mode == want.mode == ("dense" if case == "dense"
                                     else "bucketed")
    (h_w, m_w), (h_g, m_g) = want.finalize(), got.finalize()
    np.testing.assert_array_equal(h_g, h_w)
    assert h_g.dtype == np.int64 and m_g == m_w
    assert got.finalize() is got.finalize()          # idempotent


def test_mix64_device_form_is_uint64_mix64():
    """The int64 form of splitmix64 equals numpy's uint64 one on every bit
    pattern (ids ≥ 2^63 too), the JAX package's ``_mix64`` is the same
    function, and the flipped priorities sort as uint64."""
    rng = np.random.default_rng(3)
    u = rng.integers(0, 1 << 64, 50_000, dtype=np.uint64)
    u[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    want = fe._mix64(u)
    np.testing.assert_array_equal(want, jfe._mix64(u))
    got = fe._mix64_t(torch.from_numpy(u.view(np.int64)))
    np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
    flipped = got ^ fe._signed(fe._SIGN)
    order = torch.sort(flipped, stable=True).indices.numpy()
    np.testing.assert_array_equal(want[order], np.sort(want))


@pytest.mark.parametrize("stratified", [False, True])
def test_reservoir_matches_reference(stratified):
    rng = np.random.default_rng(4)
    n = 10_000
    src = rng.integers(0, 100, n).astype(np.int32)
    dst = rng.integers(0, 100, n).astype(np.int32)
    cont = rng.normal(size=(n, 2)).astype(np.float32)
    cat = rng.integers(0, 4, size=(n, 1)).astype(np.int32)
    sizes = [3000, 1, 2999, 4000]
    kw = dict(seed=7, stratified=stratified,
              total_rows=n if stratified else None)
    want = jfe.ReservoirSample(500, **kw)
    for c in _chunks(jfe, src, dst, cont, cat, sizes):
        want.update(c)
    want = want.finalize()
    got = fe.ReservoirSample(500, device="cpu", **kw)
    for c in _chunks(fe, src, dst, cont, cat, sizes)[::-1]:
        got.update(c)
    got = got.finalize()
    assert set(got) == set(want)
    for k in ("rows", "src", "dst", "cont", "cat"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got[k].dtype == want[k].dtype, k
    assert got["provenance"] == want["provenance"]
    assert len(got["rows"]) == 500


def test_reservoir_empty_stream_matches_reference():
    want = jfe.ReservoirSample(10, seed=1).finalize()
    got = fe.ReservoirSample(10, seed=1, device="cpu").finalize()
    assert set(got) == set(want) and got["provenance"] == want["provenance"]
    for k in ("rows", "src", "dst"):
        assert got[k].dtype == want[k].dtype and len(got[k]) == 0
    assert got["cont"] is None and got["cat"] is None
    with pytest.raises(ValueError, match="total_rows"):
        fe.ReservoirSample(10, stratified=True, device="cpu")


def test_moments_and_cards_match_reference_exactly():
    rng = np.random.default_rng(6)
    cont = (rng.normal(size=(9000, 3)) * 1e3).astype(np.float32)
    cat = rng.integers(0, 7, size=(9000, 2)).astype(np.int32)
    parts = [slice(0, 4000), slice(4000, 4001), slice(4001, 9000)]
    jm, jc = jfe.Moments(3), jfe.CatCards(2)
    for p in parts:
        jm.update(cont[p])
        jc.update(cat[p])
    m, c = fe.Moments(3), fe.CatCards(2)
    for p in parts[::-1]:
        m.update(cont[p])
        c.update(cat[p])
    assert m.finalize() == jm.finalize()
    assert c.cards() == jc.cards() == (7, 7)
    assert fe.Moments(0).update(np.zeros((5, 0))).finalize() == []
    with pytest.raises(ValueError, match="continuous columns"):
        fe.Moments(2).update(cont)


def test_bitpair_counts_are_int64_numpy():
    rng = np.random.default_rng(7)
    src = rng.integers(0, 1 << 10, 3000).astype(np.int32)
    mle = fe.BitPairMLE(10, 8)
    mle.update(src, src >> 2).update(src[:5], src[:5])
    want = jfe.BitPairMLE(10, 8).update(src, src >> 2).update(src[:5],
                                                              src[:5])
    assert isinstance(mle.counts, np.ndarray) and mle.counts.dtype == np.int64
    np.testing.assert_array_equal(mle.counts, want.counts)
    np.testing.assert_array_equal(fe.BitPairMLE(3, 0).counts, np.zeros((1, 4)))


# -- accumulate, fit_structure_streamed, fit_to_json --------------------------

def _stats_equal(got, want):
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "sample":
            assert set(a) == set(b)
            for k in b:
                if isinstance(b[k], np.ndarray):
                    np.testing.assert_array_equal(a[k], b[k], err_msg=k)
                    assert a[k].dtype == b[k].dtype, k
                else:
                    assert a[k] == b[k], k
        elif isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b, err_msg=f.name)
            assert a.dtype == b.dtype, f.name
        else:
            assert a == b, f.name


@pytest.mark.parametrize("case", ["int32", "int64", "wide", "featured"])
def test_accumulate_matches_reference(datasets, featured, case):
    path = featured if case == "featured" else datasets[case]
    want = jfe.accumulate(JDatasetFitSource(path, chunk_rows=5000),
                          sample_rows=800, seed=1)
    got = fe.accumulate(DatasetFitSource(path, chunk_rows=5000),
                        sample_rows=800, seed=1, device="cpu")
    _stats_equal(got, want)
    assert got.has_features == (case == "featured")


@pytest.mark.parametrize("case", ["int32", "int64", "wide", "featured"])
def test_fit_json_identical_to_reference(datasets, featured, case):
    """The port's fit JSON is the JAX package's, byte for byte, and the
    same with the shards streamed in reverse."""
    path = featured if case == "featured" else datasets[case]
    n_shards = len(ShardedGraphDataset(path))
    assert n_shards > 1
    texts = []
    want_src = JDatasetFitSource(path, chunk_rows=7000)
    want = jfe.fit_to_json(*jfe.fit_structure_streamed(
        jfe.accumulate(want_src, sample_rows=500, kmax=256), noise=0.02))
    for order in (None, list(range(n_shards))[::-1]):
        src = DatasetFitSource(path, chunk_rows=7000, shard_order=order)
        stats = fe.accumulate(src, sample_rows=500, kmax=256, device="cpu")
        texts.append(fe.fit_to_json(*fe.fit_structure_streamed(
            stats, noise=0.02, device="cpu")))
    assert texts[0] == want and texts[1] == want
    fit, prov = fe.fit_from_json(texts[0])
    assert isinstance(fit, KroneckerFit)
    assert prov["chosen"] in {c["candidate"] for c in prov["calibration"]}
    assert json.loads(texts[0])["fit"] == dataclasses.asdict(fit)


def test_uncalibrated_fit_json_identical_to_reference(datasets):
    path = datasets["int32"]
    want = jfe.fit_to_json(*jfe.fit_structure_streamed(
        jfe.accumulate(JDatasetFitSource(path), sample_rows=100),
        calibrate=False))
    got = fe.fit_to_json(*fe.fit_structure_streamed(
        fe.accumulate(DatasetFitSource(path), sample_rows=100,
                      device="cpu"), calibrate=False, device="cpu"))
    assert got == want and "calibration" not in json.loads(got)[
        "provenance"]


def test_accumulate_dataset_equals_inmemory_arrays(datasets):
    path = datasets["int32"]
    g = ShardedGraphDataset(path).to_graph(device="cpu")
    s1 = fe.accumulate(DatasetFitSource(path, chunk_rows=5000),
                       sample_rows=800, seed=1, device="cpu")
    s2 = fe.accumulate(ArrayFitSource.from_graph(g, chunk_rows=999_999),
                       sample_rows=800, seed=1, device="cpu")
    for k in ("bitpair", "hist_out", "hist_in"):
        np.testing.assert_array_equal(getattr(s1, k), getattr(s2, k))
    assert (s1.max_deg_out, s1.max_deg_in) == (s2.max_deg_out,
                                               s2.max_deg_in)
    for k in ("rows", "src", "dst"):
        np.testing.assert_array_equal(s1.sample[k], s2.sample[k])


def test_streamed_fit_recovers_theta(datasets):
    stats = fe.accumulate(DatasetFitSource(datasets["int32"]),
                          sample_rows=500, device="cpu")
    fit, prov = fe.fit_structure_streamed(stats, device="cpu")
    truth = (FIT["a"], FIT["b"], FIT["c"], FIT["d"])
    assert max(abs(a - b) for a, b in zip(prov["theta_mle"], truth)) < 0.02
    assert max(abs(x - y) for x, y in
               zip((fit.a, fit.b, fit.c, fit.d), truth)) < 0.07
    assert (fit.n, fit.m, fit.E) == (FIT["n"], FIT["m"], FIT["E"])


def _refit64_stats(mod):
    """The scale-64 dataset's one-pass stats (163 840 000 rows, about 625
    edges a node) as ``mod.StreamFitStats``: the fit JSON's provenance
    plus the two degree histograms, checked against its digests."""
    text = (FIXTURES / "refit64.json").read_text()
    doc = json.loads(text)
    fit, prov = doc["fit"], doc["provenance"]
    sk = prov["degree_sketch"]
    hists = np.load(FIXTURES / "refit64_hists.npz")
    stats = mod.StreamFitStats(
        n=prov["n"], m=prov["m"], n_src=2 ** fit["n"], n_dst=2 ** fit["m"],
        bipartite=fit["bipartite"], rows=prov["rows"],
        n_chunks=prov["n_chunks"],
        bitpair=np.asarray(prov["bitpair_counts"], np.int64),
        hist_out=hists["hist_out"], hist_in=hists["hist_in"],
        max_deg_out=sk["max_deg_out"], max_deg_in=sk["max_deg_in"],
        kmax=sk["kmax"], sample={"provenance": prov["sample"]},
        moments=prov["moments"], n_cont=prov["n_cont"],
        cat_cards=tuple(prov["cat_cards"]), has_features=False,
        source=prov["source"])
    assert stats._hist_digest(stats.hist_out) == sk["hist_out_digest"]
    assert stats._hist_digest(stats.hist_in) == sk["hist_in_digest"]
    return text, prov, stats


@pytest.mark.parametrize("package", ["jax", "torch"])
def test_refit64_stats_give_the_cards_fit_json(package):
    """At the main path's density the calibration ladder of both packages
    chooses what the card chose, ``indep_skew_0.93``, whose θ is 0.167
    from the generator's: past ``fit_dataset --check-theta 0.07``, while
    the uncalibrated MLE + Eq. 6 fit stays within it."""
    _require_partitionable()
    text, prov, stats = _refit64_stats(jfe if package == "jax" else fe)
    if package == "jax":
        fit, got = jfe.fit_structure_streamed(stats)
        eq6, _ = jfe.fit_structure_streamed(stats, calibrate=False)
        dump = jfe.fit_to_json
    else:
        fit, got = fe.fit_structure_streamed(stats, device="cpu")
        eq6, _ = fe.fit_structure_streamed(stats, calibrate=False,
                                           device="cpu")
        dump = fe.fit_to_json
    got["generator"] = prov["generator"]
    assert dump(fit, got) == text
    assert got["chosen"] == "indep_skew_0.93"
    gen = prov["source"]["generator_fit"]
    err = max(abs(getattr(fit, k) - gen[k]) for k in "abcd")
    eq6_err = max(abs(getattr(eq6, k) - gen[k]) for k in "abcd")
    assert err > 0.07 and eq6_err <= 0.07
