"""The committed fit and the state round trip of the port's generation
slice, on the CPU, without JAX: the asset loads and generates in range,
and ``pipeline_from_state(state_from_pipeline(p))`` generates what ``p``
generates (struct ids exact, aligned rows equal on ≥ 99% of rows, GBDT
scores within 1e-5 — the tolerances of ``tests/test_torch_pipeline.py``,
from which these tests were split).
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"


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


def _row_match(c1, k1, c2, k2) -> float:
    same_cat = (np.asarray(k1) == np.asarray(k2)).all(1)
    same_cont = np.isclose(np.asarray(c1), np.asarray(c2), rtol=1e-5,
                           atol=1e-5).all(1)
    return float((same_cat & same_cont).mean())


def test_asset_generates_on_cpu():
    """The committed fit (the one the card runs at scale) loads without
    JAX and generates in range."""
    pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                       device="cpu")
    st = pipe.struct
    assert (st.n, st.m, st.E) == (12, 9, 40_000) and st.noise > 0
    assert pipe.features.schema.n_cont == 2
    g, cont, cat = pipe.generate(seed=0, chunked=True)
    assert g.n_edges == st.E and int(g.src.max()) < 2 ** st.n
    assert int(g.dst.max()) < 2 ** st.m
    assert torch.isfinite(cont).all()
    cards = torch.tensor(pipe.features.schema.cat_cards)
    assert ((cat >= 0) & (cat < cards)).all()


@pytest.mark.parametrize("source", ["port_fit", "asset"])
def test_state_from_pipeline_round_trip(source):
    """``pipeline_from_state(state_from_pipeline(p))`` generates what ``p``
    generates, for a fit made by the port and for the committed asset."""
    from repro_torch.core.aligner import AlignerConfig
    from repro_torch.core.gbdt import GBDTConfig as TGBDTConfig
    from repro_torch.core.pipeline import SyntheticGraphPipeline
    from repro_torch.data.reference import tabformer_like as ttabformer_like
    if source == "asset":
        pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                           device="cpu")
    else:
        pipe = SyntheticGraphPipeline(
            noise=0.03, gan_steps=10,
            aligner_cfg=AlignerConfig(gbdt=TGBDTConfig(n_rounds=10)),
            device="cpu").fit(*ttabformer_like(n_src=256, n_dst=64,
                                               n_edges=2000))
    state = convert.state_from_pipeline(pipe)
    if source == "asset":
        asset = convert.load_state(ASSET)
        assert set(state) == set(asset)
        for k in asset:
            np.testing.assert_array_equal(state[k], asset[k], err_msg=k)
            assert state[k].dtype == asset[k].dtype, k
    back = convert.pipeline_from_state(state, device="cpu")
    g1, c1, k1 = pipe.generate(seed=4, chunked=True)
    g2, c2, k2 = back.generate(seed=4, chunked=True)
    np.testing.assert_array_equal(g2.src.numpy(), g1.src.numpy())
    np.testing.assert_array_equal(g2.dst.numpy(), g1.dst.numpy())
    assert _row_match(c1, k1, c2, k2) >= 0.99
    X = pipe.aligner._inputs(g1)
    for a, b in zip(pipe.aligner.cont_models, back.aligner.cont_models):
        np.testing.assert_allclose(b.predict(X).numpy(), a.predict(X).numpy(),
                                   rtol=0, atol=1e-5)
