"""The port's copies of the paper's examples (``repro_torch.examples``)
against the JAX package's ``examples/``, on the CPU.

* ``trillion_edge_plan``: the 1e12-edge chunk plan (sizes, sum) equal;
  the 2^20-edge miniature's ids equal on the reference stream (the JAX
  example's ``xla`` stream on the CPU), so the recovered θ and the
  quadrant counts are equal too;
* ``serve_batched``: the served tokens of the 10 requests equal the JAX
  engine's with the JAX weights carried across by ``convert``, in float32
  (the example's bfloat16 sums run in another order than XLA's, so a
  near-tie can flip a greedy token there);
* ``quickstart``: the fitted θ_S equal to the JAX package's
  ``fit_structure`` of the same graph to 1e-6, and ``main`` runs to its
  end with finite scores;
* ``pretrain_finetune_gnn``: ``main`` runs to its end, accuracies in
  [0, 1].
"""
import importlib.util
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro_torch import convert

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The examples' torch ops on one CPU thread: as fast here as eight
    (e.g. the miniature's draw), and no thread pool left spinning when
    the suite runs several test processes side by side."""
    import torch
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(text, *prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


def test_trillion_edge_plan_matches_reference(capsys):
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode")
    from repro_torch.examples import trillion_edge_plan
    got = trillion_edge_plan.main(device="cpu")
    ours = capsys.readouterr().out
    _jax_example("trillion_edge_plan").main()
    theirs = capsys.readouterr().out
    keep = ("target:", "chunk plan:", "miniature:", "edges per src-prefix")
    assert _lines(ours, *keep) == _lines(theirs, *keep)
    assert len(_lines(ours, *keep)) == 4
    from repro.core import rmat as jrmat
    from repro.core.structure import KroneckerFit as JFit
    target = JFit(a=0.45, b=0.22, c=0.2, d=0.13, n=32, m=32, E=int(1.0e12))
    want = np.array([c.n_edges for c in jrmat.chunk_plan(target, 5)])
    np.testing.assert_array_equal(got["sizes"], want)
    assert got["sizes"].sum() == 10 ** 12 and len(got["sizes"]) == 1024
    mini = JFit(a=0.45, b=0.22, c=0.2, d=0.13, n=14, m=14, E=1 << 20)
    js, jd = jrmat.sample_graph_chunked(jax.random.PRNGKey(0), mini,
                                        k_pref=2)
    np.testing.assert_array_equal(got["src"], np.asarray(js))
    np.testing.assert_array_equal(got["dst"], np.asarray(jd))


def test_serve_batched_matches_reference(capsys):
    from repro.configs import get_config as jget_config
    from repro.models import Model as JModel
    from repro.serving.engine import Request as JRequest
    from repro.serving.engine import ServingEngine as JServingEngine
    from repro_torch.examples import serve_batched
    cfg = serve_batched.config().replace(dtype="float32")
    jcfg = jget_config("tinyllama-1.1b").smoke().replace(
        vocab=512, d_model=128, n_layers=4, n_heads=4, n_kv_heads=2,
        head_dim=32, d_ff=256, dtype="float32")
    jmodel = JModel(jcfg)
    jparams = jmodel.init_params(jax.random.PRNGKey(0))
    reqs = serve_batched.requests(cfg)
    want = JServingEngine(jmodel, jparams, max_batch=4, max_len=128).run(
        [JRequest(r.rid, r.prompt, max_new=r.max_new) for r in reqs])
    params = convert.lm_params_from_numpy(
        jax.tree.map(np.asarray, jparams), cfg, "cpu")
    got = serve_batched.main(device="cpu", params=params, dtype="float32")
    assert got["out"] == want
    assert sorted(got["out"]) == list(range(10)) and got["tokens"] == 160
    assert "10 requests, 160 tokens" in capsys.readouterr().out


@pytest.fixture(scope="module")
def quickstart():
    from repro_torch.examples import quickstart
    return quickstart.main(device="cpu")


def test_quickstart_theta_matches_reference(quickstart):
    from repro.core.structure import fit_structure as jfit_structure
    from repro.data.reference import tabformer_like
    g, _, _ = tabformer_like(n_src=1024, n_dst=128, n_edges=8000)
    want = jfit_structure(g, noise=0.03)
    got = quickstart["pipe"].struct
    np.testing.assert_allclose([got.a, got.b, got.c, got.d],
                               [want.a, want.b, want.c, want.d],
                               rtol=0, atol=1e-6)
    assert (got.n, got.m, got.E) == (want.n, want.m, want.E)


def test_quickstart_scores_are_finite(quickstart):
    for scale, m in quickstart["scores"].items():
        for key in ("degree_dist", "feature_corr", "degree_feat_dist"):
            assert np.isfinite(m[key]) and 0 <= m[key] <= 1, (scale, key)


def test_pretrain_finetune_gnn_runs():
    from repro_torch.examples import pretrain_finetune_gnn
    acc = pretrain_finetune_gnn.main(device="cpu")
    assert set(acc) == {"scratch", "synthetic", "finetune"}
    assert all(np.isfinite(v) and 0 <= v <= 1 for v in acc.values())


def test_examples_run_as_modules():
    """Each example is a ``python -m`` entry point with ``--device``."""
    for name in ("quickstart", "serve_batched", "trillion_edge_plan",
                 "pretrain_finetune_gnn"):
        mod = __import__(f"repro_torch.examples.{name}", fromlist=["main"])
        assert "--device cpu" in mod.__doc__, name
        assert mod.main.__defaults__[0] == "cuda", name
    assert "jax" not in sys.modules["repro_torch.examples.quickstart"].__dict__
