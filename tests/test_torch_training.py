"""The port's optimizer, train step and remat against the JAX package's,
on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port; weights and optimizer state cross over as numpy arrays
(``convert``).  Tolerances, each with its reason:

* ``lr_schedule`` and ``apply_update`` on random float32 trees: 1e-6, a
  few float32 roundings (XLA's ``cos``/``pow`` against torch's);
* one train step on ``tests/test_trainer.py``'s tiny config in float32:
  loss within 2e-6 and ``grad_norm`` within 1e-6 relative (the same
  products summed in another order); masters within 5e-5, a tenth of the
  step's lr: Adam's first update is lr·g/(|g| + 1e-8), which turns the
  1e-8-sized gradient differences of weights whose gradient is itself
  near 1e-8 into a part of lr;
* M = 4 against M = 1 in the port: the reference's own bounds
  (``test_microbatch_equivalence``): loss 1e-4, masters 1e-5;
* remat on against off: equal bit for bit, the recompute runs the same
  ops on the same inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_families_common import CountWeightProducts
from repro.configs import get_config as jget_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import Model as JModel
from repro.training import optimizer as jopt
from repro.training.steps import make_train_step as jmake_train_step
from repro.utils import split_by_tree as jsplit_by_tree
from repro.utils import tree_bytes as jtree_bytes
from repro.utils import tree_size as jtree_size
from repro_torch import convert, random as tr, utils
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import Model, transformer
from repro_torch.models.params import leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.steps import make_train_step

CPU = "cpu"
HP = dict(lr=1e-3, warmup_steps=2, total_steps=20)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one CPU thread: as fast here at these sizes, and no
    thread pool left spinning beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def _tiny(get, **kw):
    """``tests/test_trainer.py``'s config."""
    return get("tinyllama-1.1b").smoke().replace(
        n_layers=2, vocab=64, d_model=32, n_heads=2, n_kv_heads=2,
        head_dim=16, d_ff=64, **kw)


def _batch(vocab, B=8, S=16, seed=0):
    t = np.random.default_rng(seed).integers(0, vocab, (B, S + 1),
                                             dtype=np.int32)
    return {"tokens": t[:, :-1], "labels": t[:, 1:]}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _both(dtype="float32", **kw):
    """The JAX model, its params and optimizer state, and the port's
    model with the same params and state carried across."""
    jm = JModel(_tiny(jget_config, dtype=dtype, **kw))
    jp = jm.init_params(jax.random.PRNGKey(0))
    jo = jopt.init_opt_state(jp)
    m = Model(_tiny(get_config, dtype=dtype, **kw), CPU)
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp), m.cfg, CPU)
    o = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo), CPU)
    return jm, jp, jo, m, p, o


def _random_tree(rng, positive=False):
    def leaf(*shape):
        a = rng.standard_normal(shape).astype(np.float32)
        return np.abs(a) * 1e-3 if positive else a
    return {"a": leaf(3, 5), "b": [leaf(7), {"c": leaf(2, 3, 4)}],
            "d": leaf(1)}


def _tensors(tree):
    return jax.tree.map(lambda a: torch.from_numpy(a.copy()), tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("hp", [
    dict(), dict(warmup_steps=0, total_steps=50, min_lr_frac=0.0),
    dict(lr=1e-2, warmup_steps=7, total_steps=7)], ids=str)
def test_lr_schedule_matches_reference(hp):
    steps = np.array([0, 1, 2, 5, 7, 50, 99, 100, 101, 5000, 10000, 20000],
                     np.int32)
    want = jopt.lr_schedule(jopt.OptConfig(**hp), jnp.asarray(steps))
    got = opt.lr_schedule(opt.OptConfig(**hp), torch.from_numpy(steps))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("seed,step,clip", [(0, 0, 1.0), (1, 41, 1.0),
                                            (2, 3, 1e3)])
def test_apply_update_matches_reference(seed, step, clip):
    rng = np.random.default_rng(seed)
    grads, master = _random_tree(rng), _random_tree(rng)
    mu, nu = _random_tree(rng), _random_tree(rng, positive=True)
    hp = dict(warmup_steps=5, total_steps=60, max_grad_norm=clip)
    jstate = jopt.OptState(master=master, mu=mu, nu=nu,
                           step=jnp.asarray(step, jnp.int32))
    jparams, jnew, jm = jopt.apply_update(
        jax.tree.map(jnp.asarray, grads), jax.tree.map(jnp.asarray, jstate),
        jopt.OptConfig(**hp), jnp.bfloat16)
    state = opt.OptState(master=_tensors(master), mu=_tensors(mu),
                         nu=_tensors(nu),
                         step=torch.tensor(step, dtype=torch.int32))
    params, new, m = opt.apply_update(_tensors(grads), state,
                                      opt.OptConfig(**hp), torch.bfloat16)
    assert int(new.step) == int(jnew.step) == step + 1
    for k in ("lr", "grad_norm"):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-6)
    for got, want in ((new.master, jnew.master), (new.mu, jnew.mu),
                      (new.nu, jnew.nu)):
        for g, w in zip(leaves(got), jax.tree.leaves(want)):
            assert g.dtype == torch.float32
            np.testing.assert_allclose(_np(g), _np(w), rtol=1e-6, atol=1e-6)
    for g, w in zip(leaves(params), jax.tree.leaves(jparams)):
        assert g.dtype == torch.bfloat16
        # the same masters, one bf16 rounding each: equal but where a
        # master sits within 1e-6 of a bf16 rounding boundary
        np.testing.assert_allclose(_np(g), _np(w), rtol=2 ** -8, atol=0)


def test_global_norm_and_abstract_state_match_reference():
    rng = np.random.default_rng(3)
    tree = _random_tree(rng)
    np.testing.assert_allclose(float(opt.global_norm(_tensors(tree))),
                               float(jopt.global_norm(tree)), rtol=1e-6)
    jm = JModel(_tiny(jget_config))
    m = Model(_tiny(get_config), CPU)
    want = jopt.abstract_opt_state(jm.abstract_params())
    got = opt.abstract_opt_state(m.abstract_params())
    for g, w in zip(utils.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[1] == str(w.dtype)
    state = opt.init_opt_state(m.init_params(tr.PRNGKey(0)))
    assert [tuple(x.shape) for x in utils.tree_leaves(state)] == \
        [w.shape for w in jax.tree.leaves(want)]
    assert state.step.dtype == torch.int32 and int(state.step) == 0


# ---------------------------------------------------------------------------
# train step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("M", [1, 4])
def test_train_step_matches_reference(M):
    jm, jp, jo, m, p, o = _both(microbatches=M)
    jstep = jax.jit(jmake_train_step(jm, jopt.OptConfig(**HP)))
    step = make_train_step(m, opt.OptConfig(**HP))
    for s in range(2):
        b = _batch(m.cfg.vocab, seed=s)
        jp, jo, jmet = jstep(jp, jo, b)
        p, o, met = step(p, o, b)
        assert abs(float(met["loss"]) - float(jmet["loss"])) < 2e-6
        np.testing.assert_allclose(float(met["grad_norm"]),
                                   float(jmet["grad_norm"]), rtol=1e-6)
        assert float(met["lr"]) == pytest.approx(float(jmet["lr"]), rel=1e-6)
        assert int(o.step) == int(jo.step) == s + 1
        for g, w in zip(leaves(o.master), jax.tree.leaves(jo.master)):
            np.testing.assert_allclose(_np(g), _np(w), rtol=0, atol=5e-5)
        # the module's weights are the masters in the model's dtype
        for g, w in zip(leaves(p.tree()), leaves(o.master)):
            assert torch.equal(g.detach(), w)


def test_microbatch_equivalence():
    """M = 1 against M = 4 in the port, as ``test_microbatch_equivalence``
    holds the reference's."""
    cfg = _tiny(get_config, dtype="float32")
    m1, m4 = (Model(cfg.replace(microbatches=M), CPU) for M in (1, 4))
    hp = opt.OptConfig(lr=1e-3, warmup_steps=0)
    b = _batch(cfg.vocab)
    out = []
    for m in (m1, m4):
        p = m.init_params(tr.PRNGKey(0))
        out.append(make_train_step(m, hp)(p, opt.init_opt_state(p), b))
    (_, o1, r1), (_, o4, r4) = out
    assert abs(float(r1["loss"]) - float(r4["loss"])) < 1e-4
    d = max(float((a - b).abs().max())
            for a, b in zip(leaves(o1.master), leaves(o4.master)))
    assert d < 1e-5, d


@pytest.mark.parametrize("scan_layers", [True, False])
def test_every_leaf_gets_its_gradient(scan_layers):
    """Gradients come out in the reference's tree (stacked ``(L, ...)``
    leaves with ``scan_layers``) and every leaf moves: no gradient is cut
    between a layer's view and its stacked leaf."""
    cfg = _tiny(get_config, dtype="float32", scan_layers=scan_layers)
    m = Model(cfg, CPU)
    p = m.init_params(tr.PRNGKey(0))
    before = [w.detach().clone() for w in leaves(p.tree())]
    shapes = [tuple(w.shape) for w in
              jax.tree.leaves(JModel(_tiny(jget_config,
                                           scan_layers=scan_layers))
                              .abstract_params())]
    p, o, _ = make_train_step(m, opt.OptConfig(**HP))(
        p, opt.init_opt_state(p), _batch(cfg.vocab))
    assert [tuple(w.shape) for w in leaves(o.master)] == shapes
    for w0, w in zip(before, leaves(p.tree())):
        assert w.requires_grad and not torch.equal(w0, w.detach())


def _grads(m, p, b):
    ws = leaves(p.tree())
    for w in ws:
        w.requires_grad_(True)
    loss = m.loss(p, {k: torch.from_numpy(np.ascontiguousarray(v))
                      for k, v in b.items()})
    return loss, torch.autograd.grad(loss, ws)


@pytest.mark.parametrize("policy", ["nothing", "dots"])
def test_remat_matches_no_remat(policy, monkeypatch):
    cfg = _tiny(get_config, dtype="float32", remat_policy=policy)
    b = _batch(cfg.vocab)
    runs = {}
    for remat in (False, True):
        m = Model(cfg.replace(remat=remat), CPU)
        p = m.init_params(tr.PRNGKey(0))
        calls = []
        block = transformer.dense_block
        monkeypatch.setattr(transformer, "dense_block",
                            lambda *a, **k: calls.append(1) or block(*a, **k))
        counter = CountWeightProducts()
        ws = leaves(p.tree())
        for w in ws:
            w.requires_grad_(True)
        loss = m.loss(p, {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in b.items()})
        with counter:
            grads = torch.autograd.grad(loss, ws)
        monkeypatch.setattr(transformer, "dense_block", block)
        runs[remat] = (loss, grads, len(calls), counter.n)
    (l0, g0, n0, mm0), (l1, g1, n1, mm1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for a, c in zip(g0, g1):
        assert torch.equal(a, c)
    # remat reruns each block's forward in the backward; "dots" keeps the
    # weight products' outputs, so the rerun computes none of them again
    assert (n0, n1) == (cfg.n_layers, 2 * cfg.n_layers)
    assert (mm1 > mm0) == (policy != "dots"), (mm0, mm1)


def test_remat_keeps_inference_paths():
    """Without gradients (scoring, serving) no block runs under remat."""
    cfg = _tiny(get_config, dtype="float32")
    m = Model(cfg, CPU)
    p = m.init_params(tr.PRNGKey(0))
    toks = torch.from_numpy(_batch(cfg.vocab)["tokens"])
    want = m.forward(p, {"tokens": toks}).logits
    for w in leaves(p.tree()):
        w.requires_grad_(True)
    with torch.no_grad():
        got = m.forward(p, {"tokens": toks}).logits
    assert torch.equal(got, want) and not got.requires_grad


def test_flash_raises_under_autograd():
    """Both packages refuse to differentiate through the flash kernel; a
    forward without gradients still runs it."""
    jcfg = _tiny(jget_config, dtype="float32").replace(attn_impl="flash")
    jm = JModel(jcfg)
    jp = jm.init_params(jax.random.PRNGKey(0))
    b = _batch(jcfg.vocab, B=1, S=128)
    with pytest.raises(AssertionError):
        jax.value_and_grad(jm.loss)(jp, b)

    cfg = _tiny(get_config, dtype="float32").replace(attn_impl="flash")
    m = Model(cfg, CPU)
    p = m.init_params(tr.PRNGKey(0))
    with pytest.raises(RuntimeError, match="no backward"):
        _grads(m, p, b)
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(m, opt.OptConfig(**HP))(p, opt.init_opt_state(p), b)
    with torch.no_grad():
        loss = m.loss(p, {k: torch.from_numpy(np.ascontiguousarray(v))
                          for k, v in b.items()})
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# the abstract model API and the tree helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("scan_layers", [True, False])
def test_abstract_params_and_dims_match_reference(scan_layers):
    jm = JModel(_tiny(jget_config, scan_layers=scan_layers))
    m = Model(_tiny(get_config, scan_layers=scan_layers), CPU)
    want, got = jm.abstract_params(), m.abstract_params()
    names = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(want)[0]]
    assert [n for n, _ in utils.tree_flatten_with_path(got)] == names
    for g, w in zip(utils.tree_leaves(got), jax.tree.leaves(want)):
        assert tuple(g.shape) == w.shape
        assert str(g.dtype).split(".")[1] == str(w.dtype)
    assert utils.tree_size(got) == jtree_size(want)
    assert utils.tree_bytes(got) == jtree_bytes(want)
    assert m.param_dims() == jm.param_dims()
    p = m.init_params(tr.PRNGKey(0))
    assert utils.tree_size(p) == utils.tree_size(got)
    assert utils.tree_bytes(p) == sum(w.nbytes for w in leaves(p.tree()))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_input_specs_match_reference(kind):
    jm, m = JModel(_tiny(jget_config)), Model(_tiny(get_config), CPU)
    want = jm.input_specs(JShapeSpec("x", 128, 4, kind))
    got = m.input_specs(ShapeSpec("x", 128, 4, kind))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == torch.int32
    assert m.batch_dims(got) == jm.batch_dims(want)


def test_tree_helpers_match_reference():
    m = Model(_tiny(get_config), CPU)
    p = m.init_params(tr.PRNGKey(0))
    jp = JModel(_tiny(jget_config)).init_params(jax.random.PRNGKey(0))
    want = jax.tree.leaves(jsplit_by_tree(jax.random.PRNGKey(5), jp))
    got = leaves(utils.split_by_tree(tr.PRNGKey(5), p))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy().astype(np.uint32),
                                      np.asarray(w))
    f32 = utils.cast_tree(p, torch.float32)
    assert all(w.dtype == torch.float32 for w in leaves(f32))
    utils.assert_finite(p, "params")
    bad = utils.cast_tree(p, torch.float32)
    bad["layers"]["mlp"]["w2"][1, 0, 0] = float("nan")
    with pytest.raises(AssertionError,
                       match=r"params\['layers'\]\['mlp'\]\['w2'\]"):
        utils.assert_finite(bad, "params")
