"""The port's GCN / GAT (``repro_torch.models.gnn``) against the JAX
package's ``models/gnn.py``, on the CPU, on ``cora_like`` graphs of a few
thousand edges, hidden ≤ 32.

Tolerances: the initial weights within 1e-6 (the port's threefry normals
are within one float32 ulp of ``jax.random.normal``, ``test_torch_random``);
one forward from the same (converted) weights within 1e-5 in the logits;
the losses of a 20-step training run from the same weights within 1e-4,
step by step (float32 matmuls and segment sums round apart from XLA's
in the last ulp); the symmetrised edges and the test split exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import reference as JR
from repro.models import gnn as JN
from repro_torch import convert, random as tr
from repro_torch.graph.ops import Graph as TGraph
from repro_torch.models import gnn as TN

LOGITS, LOSS = 1e-5, 1e-4
KINDS = ["gcn", "gat"]


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _graph(bipartite=False):
    if bipartite:
        jg, cont, cat = JR.tabformer_like(n_src=200, n_dst=40, n_edges=1500)
        labels = cat[:200, 0] % 7
        cont = np.random.default_rng(0).normal(
            size=(jg.n_nodes - 10, 8)).astype(np.float32)
    else:
        jg, cont, cat = JR.cora_like(n=400, n_edges=1500)
        labels = cat[:, 0]
    tg = TGraph(torch.from_numpy(np.asarray(jg.src)),
                torch.from_numpy(np.asarray(jg.dst)), jg.n_src, jg.n_dst,
                jg.bipartite)
    return jg, tg, cont, labels


def _cfgs(kind, hidden=16, n_layers=2):
    return (JN.GNNConfig(kind=kind, hidden=hidden, n_layers=n_layers),
            TN.GNNConfig(kind=kind, hidden=hidden, n_layers=n_layers))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n_layers", [2, 3])
def test_init_matches_reference(kind, n_layers):
    _require_partitionable()
    jcfg, tcfg = _cfgs(kind, 32, n_layers)
    want = JN.init_gnn(jax.random.PRNGKey(3), jcfg, 8)
    got = TN.init_gnn(tr.PRNGKey(3), tcfg, 8, device="cpu")
    assert len(got.layers) == len(want) == n_layers
    for lw, lg in zip(want, got.layers):
        assert [n for n, _ in lg.named_parameters()] == list(lw)
        for k in lw:
            np.testing.assert_allclose(getattr(lg, k).detach().numpy(),
                                       np.asarray(lw[k]), rtol=0, atol=1e-6)
        if kind == "gat":       # the reference's reused key (ROADMAP C9)
            assert torch.equal(lg.att_src, lg.att_dst)


@pytest.mark.parametrize("bipartite", [False, True])
def test_symmetrised_edges_are_the_reference(bipartite):
    jg, tg, _, _ = _graph(bipartite)
    heads, tails, n = JN._sym_edges(jg)
    e = TN.SymEdges(tg, "cpu")
    assert e.n == n
    pairs = np.stack([np.asarray(heads), np.asarray(tails)], 1)
    order = np.argsort(np.asarray(tails), kind="stable")
    np.testing.assert_array_equal(e.heads.numpy(), pairs[order, 0])
    np.testing.assert_array_equal(e.tails.numpy(), pairs[order, 1])
    np.testing.assert_array_equal(e.lengths.numpy(),
                                  np.bincount(np.asarray(tails), minlength=n))
    np.testing.assert_array_equal(e.deg.numpy(), np.asarray(
        jax.ops.segment_sum(jnp.ones_like(heads, jnp.float32), heads, n)))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("bipartite", [False, True])
def test_forward_from_converted_params(kind, bipartite):
    jg, tg, cont, _ = _graph(bipartite)
    x = np.zeros((jg.n_nodes, cont.shape[1]), np.float32)
    x[: len(cont)] = cont
    jcfg, tcfg = _cfgs(kind)
    jp = JN.init_gnn(jax.random.PRNGKey(1), jcfg, x.shape[1])
    model = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          tcfg, device="cpu")
    heads, tails, n = JN._sym_edges(jg)
    fwd = JN.gcn_forward if kind == "gcn" else JN.gat_forward
    want = np.asarray(fwd(jp, jnp.asarray(x), heads, tails, n))
    got = model(torch.from_numpy(x), TN.SymEdges(tg, "cpu"))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=LOGITS)


@pytest.mark.parametrize("kind", KINDS)
def test_training_losses_step_by_step(kind):
    """``make_node_classifier``'s steps from the same weights: the loss of
    every step, the momentum update by hand (m = 0.9·o + 0.1·g from 0,
    p −= lr·m), the weights after 20 steps and the predictions."""
    jg, tg, cont, labels = _graph()
    jcfg, tcfg = _cfgs(kind)
    jp = JN.init_gnn(jax.random.PRNGKey(0), jcfg, cont.shape[1])
    model = convert.gnn_params_from_numpy(jax.tree.map(np.asarray, jp),
                                          tcfg, device="cpu")
    j_step, j_pred = JN.make_node_classifier(jcfg, jg)
    t_step, t_pred = TN.make_node_classifier(tcfg, tg, device="cpu")
    mask = (np.arange(jg.n_nodes) % 3 != 0).astype(np.float32)
    jo = jax.tree.map(jnp.zeros_like, jp)
    to = [torch.zeros_like(p) for p in model.parameters()]
    args_j = (jnp.asarray(cont), jnp.asarray(labels), jnp.asarray(mask))
    args_t = (torch.from_numpy(cont), torch.from_numpy(labels.astype(
        np.int64)), torch.from_numpy(mask))
    for _ in range(20):
        jp, jo, lj = j_step(jp, jo, *args_j)
        lt = t_step(model, to, *args_t)
        assert float(lt) == pytest.approx(float(lj), abs=LOSS)
    for lw, lg in zip(jp, model.layers):
        for k in lw:
            np.testing.assert_allclose(getattr(lg, k).detach().numpy(),
                                       np.asarray(lw[k]), rtol=0, atol=1e-5)
    same = (t_pred(model, args_t[0]).numpy()
            == np.asarray(j_pred(jp, args_j[0])))
    assert same.mean() >= 0.99


@pytest.mark.parametrize("kind", KINDS)
def test_train_node_classifier_matches_reference(kind):
    """The whole loop: numpy's split, ``init_gnn(PRNGKey(seed))``, 15
    epochs; the port's weights within 1e-5 of the reference's, test
    accuracies within one test node, and the port's loss history ends at
    the loss of its final weights' previous step."""
    _require_partitionable()
    jg, tg, cont, labels = _graph()
    jcfg, tcfg = _cfgs(kind)
    jp, jacc = JN.train_node_classifier(jg, cont, labels, jcfg, epochs=15,
                                        seed=2)
    model, acc, losses = TN.train_node_classifier(tg, cont, labels, tcfg,
                                                  epochs=15, seed=2,
                                                  device="cpu")
    n_test = len(labels) - int(len(labels) * 0.6)
    assert abs(acc - jacc) <= 1.0 / n_test + 1e-12
    assert losses.shape == (15,) and np.isfinite(losses).all()
    assert losses[-1] < losses[0]
    for lw, lg in zip(jp, model.layers):
        for k in lw:
            np.testing.assert_allclose(getattr(lg, k).detach().numpy(),
                                       np.asarray(lw[k]), rtol=0, atol=1e-5)


def test_training_from_given_model_and_padding():
    """``train_node_classifier`` is ``make_node_classifier``'s step on a
    given model, ``init_gnn(PRNGKey(seed))``, trained in place over
    numpy's split; features with fewer rows than nodes are zero-padded,
    labels too."""
    jg, tg, cont, labels = _graph(bipartite=True)
    _, tcfg = _cfgs("gcn")
    model, acc, losses = TN.train_node_classifier(
        tg, cont, labels, tcfg, epochs=3, seed=5, device="cpu")
    assert 0.0 <= acc <= 1.0 and losses.shape == (3,)
    n = tg.n_nodes
    start = TN.init_gnn(tr.PRNGKey(5), tcfg, cont.shape[1], device="cpu")
    before = [p.detach().clone() for p in start.parameters()]
    x = torch.zeros(n, cont.shape[1])
    x[:len(cont)] = torch.from_numpy(cont)
    y = torch.zeros(n, dtype=torch.int64)
    y[:len(labels)] = torch.from_numpy(labels.astype(np.int64))
    mask = torch.zeros(n)
    idx = np.random.default_rng(5).permutation(len(labels))
    mask[idx[:int(len(labels) * 0.6)]] = 1.0
    step, _ = TN.make_node_classifier(tcfg, tg, device="cpu")
    opt = [torch.zeros_like(p) for p in start.parameters()]
    want = torch.stack([step(start, opt, x, y, mask) for _ in range(3)])
    np.testing.assert_array_equal(losses, want.numpy())
    for a, b in zip(model.parameters(), start.parameters()):
        # the same steps; the CPU's vectorised sums may round a bias's
        # gradient an ulp apart between two tensors of the same values
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=0, atol=1e-9)
    assert any(not torch.equal(a, b) for a, b in zip(before,
                                                     start.parameters()))
    with pytest.raises(ValueError, match="unknown GNN kind"):
        TN.init_gnn(tr.PRNGKey(0), TN.GNNConfig(kind="sage"), 4,
                    device="cpu")
