"""The port's ``FitSource``, ``fit_streamed`` and ``fit_dataset`` CLI
against the JAX package's, on the CPU.

Datasets are written by the port's ``DatasetJob`` (``reference`` stream)
and read by both packages.  Held exactly: every ``FitChunk`` the sources
yield (arrays, dtypes, global row offsets, in any shard order, with and
without the feature columns) and their ``describe()``; after
``fit_streamed``, the ``struct/``, ``schema/``, ``gan/vgm/`` and
``pipe/`` state and the fit JSON (the GAN's weights and the forests are
held by ``tests/test_torch_fit.py``'s tolerances; here the GAN's losses
must be finite and the aligner's holdout qualities within 0.02); the
CLI's JSON, byte for byte with ``scripts/fit_dataset.py``'s.  Featured
runs are compared within one process: a featured CPU dataset's bytes
may differ from another process's in the last bits (ROADMAP C7).
"""
import dataclasses
import importlib.util
import json
import os
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.core import fit_engine as jfe
from repro.core.aligner import AlignerConfig as JAlignerConfig
from repro.core.gbdt import GBDTConfig as JGBDTConfig
from repro.core.pipeline import SyntheticGraphPipeline as JPipeline
from repro.datastream import fitsource as jfs
from repro.graph.ops import Graph as JGraph
from repro_torch import convert
from repro_torch import datastream
from repro_torch.core import fit_engine as fe
from repro_torch.core.aligner import AlignerConfig
from repro_torch.core.gbdt import GBDTConfig
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import (ArrayFitSource, DatasetFitSource,
                                    DatasetJob, FitSource,
                                    ShardedGraphDataset, as_fit_source)
from repro_torch.graph.ops import Graph
from repro_torch.scripts import fit_dataset, generate_dataset

ROOT = Path(__file__).resolve().parents[1]
FIT = dict(a=0.45, b=0.22, c=0.2, d=0.13, n=12, m=12, E=30_000)
GAN_STEPS, ROUNDS, SAMPLE = 3, 3, 2000
#: degree-sketch bins: fewer than the default 2048 keep the Eq. 6
#: refinement's host time small
KMAX = 256


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


def _load_script(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def dirs(tmp_path_factory):
    """A struct-only and a featured dataset (2 cont + 1 cat columns drawn
    by a port GAN trained two steps, placed by a random aligner)."""
    _require_partitionable()
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.features import GANFeatureGenerator
    from repro_torch.datastream import FeatureSpec
    from repro_torch.tabular.schema import infer_schema
    root = tmp_path_factory.mktemp("fitsrc")
    rng = np.random.default_rng(11)
    cont = rng.normal(size=(300, 2)).astype(np.float32)
    cat = rng.integers(0, 3, size=(300, 1)).astype(np.int32)
    schema = infer_schema(cont, cat)
    spec = FeatureSpec(
        GANFeatureGenerator(schema, device="cpu").fit(cont, cat, steps=2),
        RandomAligner(schema))
    out = {}
    for name, features in (("struct", None), ("feat", spec)):
        out[name] = str(root / name)
        DatasetJob(KroneckerFit(**FIT), out[name], shard_edges=8_000,
                   seed=0, backend="reference", device="cpu",
                   features=features).run()
    return out


def _same_chunks(got_src, want_src):
    got, want = list(got_src.chunks()), list(want_src.chunks())
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.start_row == b.start_row and a.n_rows == b.n_rows
        for f in ("src", "dst", "cont", "cat"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if y is not None:
                assert isinstance(x, np.ndarray) and x.dtype == y.dtype, f
                np.testing.assert_array_equal(x, y, err_msg=f)
    assert got_src.describe() == want_src.describe()
    for k in ("n_src", "n_dst", "bipartite", "total_rows", "has_features"):
        assert getattr(got_src, k) == getattr(want_src, k), k


# -- sources -----------------------------------------------------------------

def test_fit_source_names_are_exported():
    for name in ("FitSource", "ArrayFitSource", "DatasetFitSource",
                 "as_fit_source"):
        assert name in datastream.__all__
        assert getattr(datastream, name) is not None


@pytest.mark.parametrize("order", [None, "reversed"])
@pytest.mark.parametrize("columns", [("src", "dst", "cont", "cat"),
                                     ("src", "dst")])
def test_dataset_fit_source_matches_reference(dirs, order, columns):
    path = dirs["feat"]
    n = len(ShardedGraphDataset(path))
    shard_order = None if order is None else list(range(n))[::-1]
    kw = dict(chunk_rows=3_000, shard_order=shard_order, columns=columns)
    got = DatasetFitSource(path, **kw)
    _same_chunks(got, jfs.DatasetFitSource(path, **kw))
    assert got.has_features == ("cont" in columns)


def test_array_fit_source_matches_reference():
    rng = np.random.default_rng(12)
    src = rng.integers(0, 64, 700).astype(np.int32)
    dst = rng.integers(0, 32, 700).astype(np.int32)
    cont = rng.normal(size=(700, 2)).astype(np.float32)
    cat = rng.integers(0, 2, size=(700, 1)).astype(np.int32)
    g = Graph(torch.from_numpy(src), torch.from_numpy(dst), 64, 32, True)
    jg = JGraph(src, dst, 64, 32, bipartite=True)
    _same_chunks(ArrayFitSource.from_graph(g, cont, cat, chunk_rows=300),
                 jfs.ArrayFitSource.from_graph(jg, cont, cat,
                                               chunk_rows=300))
    _same_chunks(ArrayFitSource(src, dst), jfs.ArrayFitSource(src, dst))
    with pytest.raises(ValueError, match="lengths differ"):
        ArrayFitSource(src, dst[:-1])
    with pytest.raises(ValueError, match="feature rows"):
        ArrayFitSource(src, dst, cont[:-1])


def test_as_fit_source_coercions(dirs):
    rng = np.random.default_rng(13)
    ids = torch.from_numpy(rng.integers(0, 64, 500).astype(np.int32))
    g = Graph(ids, ids.flip(0), 64, 64)
    assert isinstance(as_fit_source(g), ArrayFitSource)
    cont = rng.normal(size=(500, 1)).astype(np.float32)
    cat = rng.integers(0, 2, size=(500, 1)).astype(np.int32)
    s = as_fit_source((g, cont, cat))
    assert s.has_features and s.total_rows == 500
    assert as_fit_source(s) is s and isinstance(s, FitSource)
    for arg in (dirs["struct"], Path(dirs["struct"]),
                ShardedGraphDataset(dirs["struct"])):
        d = as_fit_source(arg, chunk_rows=123)
        assert isinstance(d, DatasetFitSource)
        assert d.total_rows == FIT["E"] and d.chunk_rows == 123
    with pytest.raises(TypeError):
        as_fit_source(12345)
    with pytest.raises(ValueError, match="unknown shards"):
        DatasetFitSource(dirs["struct"], shard_order=[999])


# -- pipeline.fit_streamed ---------------------------------------------------

def _state_from_jax(jpipe):
    spec = importlib.util.spec_from_file_location(
        "export_torch_state", ROOT / "scripts" / "export_torch_state.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.state_from_jax_pipeline(jpipe)


def _refit(path):
    jpipe = JPipeline(noise=0.03, gan_steps=GAN_STEPS,
                      aligner_cfg=JAlignerConfig(
                          gbdt=JGBDTConfig(n_rounds=ROUNDS)))
    jpipe.fit_streamed(path, sample_rows=SAMPLE, chunk_rows=5_000,
                       kmax=KMAX)
    pipe = SyntheticGraphPipeline(
        noise=0.03, gan_steps=GAN_STEPS,
        aligner_cfg=AlignerConfig(gbdt=GBDTConfig(n_rounds=ROUNDS)),
        device="cpu")
    pipe.fit_streamed(path, sample_rows=SAMPLE, chunk_rows=5_000, kmax=KMAX)
    return jpipe, pipe


@pytest.fixture(scope="module")
def refits(dirs):
    """``fit_streamed`` of each package over the same datasets."""
    return {name: _refit(path) for name, path in dirs.items()}


def _same_state(got, want):
    assert set(got) == set(want)
    for k in want:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k.startswith(("struct/", "gan/vgm/", "schema/", "pipe/")):
            np.testing.assert_array_equal(a, b, err_msg=k)


@pytest.mark.parametrize("name", ["feat", "struct"])
def test_fit_streamed_matches_reference(refits, name):
    jpipe, pipe = refits[name]
    _same_state(convert.state_from_pipeline(pipe), _state_from_jax(jpipe))
    assert fe.fit_to_json(pipe.struct, pipe.fit_provenance) == \
        jfe.fit_to_json(jpipe.struct, jpipe.fit_provenance)
    assert (pipe.schema.n_cont, pipe.schema.cat_cards) == (
        jpipe.schema.n_cont, tuple(jpipe.schema.cat_cards))
    assert pipe.fit_provenance["sample"]["rows"] == SAMPLE
    assert pipe.timings.fit_struct_s > 0 and pipe.timings.fit_align_s > 0
    if name == "feat":
        assert pipe.schema.n_cont == 2 and pipe.schema.cat_cards == (3,)
        losses = np.asarray(pipe.features._losses)
        assert losses.shape == (1, 2) and np.isfinite(losses).all()
        np.testing.assert_allclose(pipe.aligner.col_quality,
                                   jpipe.aligner.col_quality, rtol=0,
                                   atol=0.02)
    else:
        assert pipe.schema.n_cont == 0 and pipe.schema.cat_cards == ()
        assert pipe.features._losses == [] and pipe.aligner.col_quality == []


@pytest.mark.parametrize("name", ["feat", "struct"])
def test_fit_streamed_state_round_trips(refits, name):
    """``convert.state_from_pipeline`` of a refit pipeline loads back into
    one that generates the same graph and rows."""
    _, pipe = refits[name]
    back = convert.pipeline_from_state(convert.state_from_pipeline(pipe),
                                       device="cpu")
    (g1, c1, k1), (g2, c2, k2) = (p.generate(seed=2) for p in (pipe, back))
    assert g1.n_edges == pipe.struct.E
    assert torch.equal(g1.src, g2.src) and torch.equal(g1.dst, g2.dst)
    assert torch.equal(c1, c2) and torch.equal(k1, k2)
    assert tuple(c1.shape) == (g1.n_edges, pipe.schema.n_cont)
    assert tuple(k1.shape) == (g1.n_edges, pipe.schema.n_cat)
    if name == "feat":
        assert torch.isfinite(c1).all() and int(k1.max()) < 3


def test_fit_streamed_random_aligner(dirs):
    pipe = SyntheticGraphPipeline(gan_steps=2, aligner="random",
                                  device="cpu")
    pipe.fit_streamed(dirs["feat"], sample_rows=500, kmax=KMAX)
    state = convert.state_from_pipeline(pipe)
    assert str(state["aligner/kind"]) == "random"
    g, c, k = convert.pipeline_from_state(state, "cpu").generate(seed=1)
    assert c.shape == (g.n_edges, 2) and k.shape == (g.n_edges, 1)


def test_fit_streamed_from_graph_equals_dataset(dirs):
    """An in-memory graph and its table refit as the dataset they came
    from does (``as_fit_source`` of ``(Graph, cont, cat)``)."""
    ds = ShardedGraphDataset(dirs["feat"])
    cont, cat = ds.features()
    g = ds.to_graph(device="cpu")
    a = SyntheticGraphPipeline(gan_steps=0, aligner="random", device="cpu")
    a.fit_streamed((g, cont, cat), sample_rows=500, kmax=KMAX,
                   calibrate=False)
    b = SyntheticGraphPipeline(gan_steps=0, aligner="random", device="cpu")
    b.fit_streamed(ds, sample_rows=500, kmax=KMAX, calibrate=False)
    assert a.struct == b.struct
    assert a.fit_provenance["bitpair_counts"] == \
        b.fit_provenance["bitpair_counts"]


def test_fit_streamed_from_stats_equals_dataset(dirs):
    """The stats of an ``accumulate`` pass already made refit as the
    dataset they came from does, GAN and GBDT included."""
    kw = dict(noise=0.03, gan_steps=2, device="cpu",
              aligner_cfg=AlignerConfig(gbdt=GBDTConfig(n_rounds=ROUNDS)))
    stats = fe.accumulate(DatasetFitSource(dirs["feat"]), sample_rows=500,
                          kmax=KMAX, device="cpu")
    a = SyntheticGraphPipeline(**kw).fit_streamed(stats)
    b = SyntheticGraphPipeline(**kw).fit_streamed(dirs["feat"],
                                                   sample_rows=500, kmax=KMAX)
    assert fe.fit_to_json(a.struct, a.fit_provenance) == \
        fe.fit_to_json(b.struct, b.fit_provenance)
    sa, sb = convert.state_from_pipeline(a), convert.state_from_pipeline(b)
    assert set(sa) == set(sb)
    for k in sb:
        np.testing.assert_array_equal(np.asarray(sa[k]), np.asarray(sb[k]),
                                      err_msg=k)


@pytest.mark.parametrize("kw,err,match", [
    (dict(struct="sbm"), ValueError, "kronecker"),
    (dict(struct="er"), ValueError, "kronecker"),
    (dict(features="kde"), NotImplementedError, r"ROADMAP A4"),
    (dict(features="random"), NotImplementedError, r"ROADMAP A4"),
])
def test_fit_streamed_refuses_unported_components(dirs, kw, err, match):
    with pytest.raises(err, match=match):
        SyntheticGraphPipeline(device="cpu", **kw).fit_streamed(
            dirs["struct"])


# -- the CLI -----------------------------------------------------------------

@pytest.mark.parametrize("name,extra", [("struct", []),
                                        ("feat", []),
                                        ("feat", ["--structure-only"])])
def test_fit_dataset_cli_matches_reference(dirs, tmp_path, name, extra):
    jcli = _load_script("fit_dataset")
    path = dirs[name]
    args = ["--dataset", path, "--sample-rows", "500", "--kmax", str(KMAX),
            "--check-theta", "0.07"] + extra
    want, got = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    assert jcli.main(args + ["--out", want]) == 0
    metrics = str(tmp_path / "m.json")
    assert fit_dataset.main(args + ["--out", got, "--device", "cpu",
                                    "--trace", "--metrics-out",
                                    metrics]) == 0
    with open(want) as a, open(got) as b:
        assert b.read() == a.read()
    assert os.path.getsize(got + ".trace.jsonl") > 0
    with open(metrics) as f:
        timings = json.load(f)["metrics"]["timings"]
    assert timings["fit_update_s"] > 0 and timings["accumulate_s"] > 0


def test_fit_dataset_cli_round_trip(dirs, tmp_path):
    """Two runs write the same bytes; an absurd θ tolerance fails; the
    JSON feeds ``generate_dataset --fit`` as it is."""
    path = dirs["struct"]
    outs = [str(tmp_path / f"fit{i}.json") for i in range(2)]
    for out in outs:
        assert fit_dataset.main(["--dataset", path, "--out", out,
                                 "--sample-rows", "300", "--kmax",
                                 str(KMAX), "--device", "cpu"]) == 0
    with open(outs[0]) as a, open(outs[1]) as b:
        text = a.read()
        assert text == b.read()
    assert fit_dataset.main(["--dataset", path, "--out",
                             str(tmp_path / "f3.json"), "--no-calibrate",
                             "--sample-rows", "300", "--device", "cpu",
                             "--check-theta", "1e-9"]) == 1
    d = json.loads(text)
    assert d["provenance"]["generator"]["backend"] == "xla"
    regen = str(tmp_path / "regen")
    assert generate_dataset.main(["--fit", outs[0], "--out", regen,
                                  "--shard-edges", "1e4", "--device", "cpu",
                                  "--backend", "reference"]) == 0
    man = ShardedGraphDataset(regen).manifest
    assert man.fit == d["fit"] and man.total_edges == FIT["E"]
    assert dataclasses.asdict(fe.fit_from_json(text)[0]) == d["fit"]
    with pytest.raises(SystemExit, match="error"):
        fit_dataset.main(["--dataset", str(tmp_path / "missing"), "--out",
                          str(tmp_path / "x.json"), "--device", "cpu"])
