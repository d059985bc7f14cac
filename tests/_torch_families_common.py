"""Helpers shared by the LM-family parity tests (``test_torch_moe.py``,
``test_torch_ssm_rwkv.py``, ``test_torch_families*.py``): torch on one
thread, configs of both packages at the smoke width, a scoring batch per
family, and the JAX package's weights carried into the port."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models.params import init_params as jinit_params
from repro.training import optimizer as jopt
from repro.training.steps import make_train_step as jmake_train_step
from repro_torch import convert, utils
from repro_torch.configs import get_config
from repro_torch.models import Model
from repro_torch.models.params import leaves
from repro_torch.training import optimizer as topt
from repro_torch.training.steps import make_train_step

CPU = "cpu"


NEW_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-16e", "pixtral-12b",
             "zamba2-1.2b", "rwkv6-7b", "seamless-m4t-medium"]


def logit_tol(cfg) -> dict:
    """float32 logits: 1e-4; the hybrid's 5e-4.  Its SSD chunks take exp
    of differences of cumulative sums and normalise small products, which
    float32 carries less closely than the other families' blocks: two
    float32 evaluations of the same forward (JAX and port, card and CPU)
    differ by up to ~2e-4 at the smoke width, where the other families'
    stay within 1e-5."""
    return dict(rtol=0, atol=5e-4 if cfg.family == "hybrid" else 1e-4)


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


class CountWeightProducts(torch.utils._python_dispatch.TorchDispatchMode):
    """Counts the weight products (``mm``, ``bmm`` of batch 1) that run
    under it: how remat's ``"dots"`` policy is seen to keep them."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        aten = torch.ops.aten
        if func is aten.mm.default or (func is aten.bmm.default
                                       and args[0].shape[0] == 1):
            self.n += 1
        return func(*args, **(kwargs or {}))


def cfgs(arch, dtype="float32", **kw):
    return tuple(get(arch).smoke().replace(dtype=dtype, **kw)
                 for get in (jget_config, get_config))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def port(jparams, cfg):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        cfg, CPU)


def batch_for(cfg, B=2, S=32, seed=1):
    """A scoring batch as numpy: ``S`` positions in all (VLM: patches and
    text; encdec: frames and tokens, half each)."""
    rng = np.random.default_rng(seed)
    out = {}
    n = S
    if cfg.family == "vlm":
        n = S - cfg.vlm.n_patches
        out["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        n = S // 2
        out["frames"] = rng.standard_normal(
            (B, S - n, cfg.d_model)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)
    return out


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_JPARAMS = {}


def jparams_f32(arch):
    """The JAX package's float32 smoke weights of ``arch`` (key 0), made
    once per test process."""
    if arch not in _JPARAMS:
        jcfg, _ = cfgs(arch)
        _JPARAMS[arch] = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    return _JPARAMS[arch]


def tensor32(a) -> torch.Tensor:
    """A JAX or numpy array as a float32 torch tensor (a copy)."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=tol)


def normal_np(shape, seed, scale=0.5) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def block_weights(defs_fn, jdefs_fn, arch, seed=0):
    """(jax cfg, port cfg, jax weights, the same as a namespace of
    tensors) of one block at the arch's smoke width, in float32, drawn
    from the reference's ``jdefs_fn``; the port's ``defs_fn`` must name
    the same leaves."""
    jcfg, cfg = cfgs(arch)
    jw = jinit_params(jdefs_fn(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    assert sorted(jw) == sorted(defs_fn(cfg))
    return jcfg, cfg, jw, SimpleNamespace(**{k: tensor32(v)
                                             for k, v in jw.items()})


def make_prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=n, dtype=np.int32)
            for n in lengths]


#: prompt lengths: even, since a MoE prompt's tokens must split into
#: min(n_groups, T) = 2 groups (ROADMAP C15); 2 gives the hybrid's
#: one-row conv buffer (C13), written into a slot a longer prompt held
LENGTHS = (12, 6, 2, 12, 2, 6)


# ---------------------------------------------------------------------------
# training (test_torch_families_train*.py)
# ---------------------------------------------------------------------------

#: the train tests' optimizer settings (``tests/test_torch_training.py``'s)
HP = dict(lr=1e-3, warmup_steps=2, total_steps=20)


#: the hybrid's gradients and ``grad_norm`` against the reference's: 2e-3
#: of the leaf's largest gradient (of the norm).  Its float32 gradients
#: are ill-conditioned at the smoke width: on ``batch_for(cfg, 4, 32, 5)``
#: the reference's own jitted and op-by-op (``jax.disable_jit``)
#: gradients differ by up to 7.1e-4 of the leaf's largest (the
#: embedding's, ~38) and their norms by 7.1e-4; the port's by up to
#: 6.7e-4 and 6.0e-4.  Every other family: 5e-5 and 1e-6.
HYBRID_GRAD_REL = 2e-3


def grad_tol(cfg, want) -> float:
    """The absolute limit on a float32 gradient leaf against the
    reference's ``want``: 5e-5, the hybrid's ``HYBRID_GRAD_REL`` of
    ``want``'s largest entry."""
    if cfg.family == "hybrid":
        return HYBRID_GRAD_REL * float(np.abs(f32(want)).max())
    return 5e-5


def grad_norm_rtol(cfg) -> float:
    return HYBRID_GRAD_REL if cfg.family == "hybrid" else 1e-6


def train_batches(cfg, B=4, S=32, seed=0):
    """Endless numpy training batches of ``batch_for``'s form (patches or
    frames where the family takes them), one seed apart."""
    while True:
        yield batch_for(cfg, B, S, seed)
        seed += 1


def capture_grads(monkeypatch) -> None:
    """Both packages' ``make_train_step`` hand on their float32 gradients
    in the step's metrics, under ``"grads"``: ``apply_update`` is wrapped
    where the steps call it (``optimizer.apply_update``)."""
    for mod in (jopt, topt):
        def wrapped(grads, *args, real=mod.apply_update):
            params, state, metrics = real(grads, *args)
            return params, state, {**metrics, "grads": grads}
        monkeypatch.setattr(mod, "apply_update", wrapped)


def step_both(arch, monkeypatch, M=1, seed=5, S=32, **kw):
    """One train step of each package from the same weights (the
    reference's float32 ``PRNGKey(0)`` draw) and a fresh optimizer state,
    on a ``batch_for`` batch of 4 x ``S``: (port cfg, the reference's new
    state and metrics, the port's params, state and metrics, leaf
    names)."""
    capture_grads(monkeypatch)
    jcfg, cfg = cfgs(arch, microbatches=M, **kw)
    jp = jparams_f32(arch)
    jo = jopt.init_opt_state(jp)
    p = port(jp, cfg)
    o = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo), CPU)
    b = batch_for(cfg, B=4, S=S, seed=seed)
    jstep = jax.jit(jmake_train_step(JModel(jcfg), jopt.OptConfig(**HP)))
    _, jo, jmet = jstep(jp, jo, jb(b))
    p, o, met = make_train_step(Model(cfg, CPU), topt.OptConfig(**HP))(
        p, o, b)
    names = [n for n, _ in utils.tree_flatten_with_path(p.tree())]
    return cfg, (jo, jmet), (p, o, met), names


def check_step(cfg, ref, got, names):
    """``step_both``'s two steps agree: loss within 1e-6 relative;
    ``grad_norm`` within ``grad_norm_rtol``; every gradient present,
    finite and within ``grad_tol``; the masters as below."""
    (jo, jmet), (p, o, met) = ref, got
    np.testing.assert_allclose(float(met["loss"]), float(jmet["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(met["grad_norm"]),
                               float(jmet["grad_norm"]),
                               rtol=grad_norm_rtol(cfg))
    want = jax.tree.leaves(jmet["grads"])
    grads = leaves(met["grads"])
    assert [tuple(g.shape) for g in grads] == [w.shape for w in want]
    tols = [grad_tol(cfg, w) for w in want]
    for name, g, w, tol in zip(names, grads, want, tols):
        assert bool(g.isfinite().all()), name
        np.testing.assert_allclose(f32(g), f32(w), rtol=0, atol=tol,
                                   err_msg=name)
    # Adam's first update is lr·c·g/(|c·g| + 1e-8), c the clip factor
    # min(1, max_grad_norm / grad_norm): a gradient error within ``tol``
    # moves it by under lr·1e-8·tol/(c·g²), which is below 5e-5 where
    # |g| >= sqrt(lr·1e-8·tol/(5e-5·c)); where the gradient is nearer 0
    # the update may take either sign, within 2·lr
    lr = float(jmet["lr"])
    c = min(1.0, HP.get("max_grad_norm", jopt.OptConfig().max_grad_norm)
            / float(jmet["grad_norm"]))
    for name, g, w, gw, tol in zip(names, leaves(o.master),
                                   jax.tree.leaves(jo.master), want, tols):
        d = np.abs(f32(g) - f32(w))
        big = np.abs(f32(gw)) >= max(1e-5, np.sqrt(lr * 1e-8 * tol
                                                   / (5e-5 * c)))
        assert d[big].max(initial=0) < 5e-5, name
        assert d.max() <= 2 * lr, name
    assert int(o.step) == int(jo.step) == 1


def trainers_both(arch, steps=20):
    """``steps`` ``Trainer`` steps of each package in float32, each drawing
    its weights from ``PRNGKey(0)`` (the port's normal is within one
    float32 ulp of jax's), over the same ``train_batches``: (the
    reference's history, the port's)."""
    from repro.training.trainer import Trainer as JTrainer
    from repro.training.trainer import TrainerConfig as JTrainerConfig
    from repro_torch import random as tr
    from repro_torch.training.trainer import Trainer, TrainerConfig
    jcfg, cfg = cfgs(arch)
    jt = JTrainer(JModel(jcfg), jopt.OptConfig(**HP),
                  JTrainerConfig(total_steps=steps, log_every=1000))
    jt.fit(jax.random.PRNGKey(0), train_batches(jcfg))
    t = Trainer(Model(cfg, CPU), topt.OptConfig(**HP),
                TrainerConfig(total_steps=steps, log_every=1000))
    t.fit(tr.PRNGKey(0), train_batches(cfg))
    assert [h["step"] for h in t.history] == list(range(1, steps + 1))
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
               and h["grad_norm"] > 0 for h in t.history)
    return jt.history, t.history
