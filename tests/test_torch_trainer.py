"""The port's Trainer, checkpoints, data pipeline and the fifth example
against the JAX package's, on the CPU.

The same seeds go through both packages.  Tolerances, each with its
reason:

* 20 ``Trainer`` steps on ``SyntheticTokens``, each package drawing its
  weights from ``PRNGKey(0)`` (the port's normal is within one float32
  ulp of jax's): losses per step within 1e-5 in float32 (sums in another
  order), 1e-2 in bfloat16 (the two frameworks round bf16 products and
  gradients at other places; a loss near 4 has a bf16 step of 1.6e-2);
* the example at a reduced width, in bfloat16: the same generated graph
  and tokens exactly, the first losses within 1e-2 as above;
* checkpoints, token batches, loader slices, resumed runs: exact."""
import json
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.data import pipeline as jdata
from repro.data.reference import paysim_like as jpaysim_like
from repro.distributed import checkpoint as jckpt
from repro.models import Model as JModel
from repro.training import optimizer as jopt
from repro.training.trainer import Trainer as JTrainer
from repro.training.trainer import TrainerConfig as JTrainerConfig
from repro_torch import convert, random as tr
from repro_torch.configs import get_config
from repro_torch.data import pipeline as data
from repro_torch.data.reference import paysim_like
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.models import Model
from repro_torch.models.params import leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.trainer import Trainer, TrainerConfig

CPU = "cpu"


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


def _loader(vocab, batch=8, seq=16, skip=0):
    it = data.SyntheticTokens(vocab, seed=0).batches(batch, seq)
    for _ in range(skip):
        next(it)
    return it


def _trainer(tmp_path=None, total=20, dtype="bfloat16", **hp):
    cfg = _tiny(get_config, dtype=dtype)
    hp = {**dict(lr=1e-3, warmup_steps=2, total_steps=20), **hp}
    tcfg = TrainerConfig(total_steps=total, ckpt_every=5, log_every=1000,
                         ckpt_dir=None if tmp_path is None else str(tmp_path))
    return Trainer(Model(cfg, CPU), opt.OptConfig(**hp), tcfg)


def _state_leaves(params, opt_state):
    return leaves(params.tree()) + leaves(opt_state.master) + \
        leaves(opt_state.mu) + leaves(opt_state.nu) + [opt_state.step]


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("bfloat16", 1e-2)])
def test_trainer_follows_reference(dtype, tol):
    hp = dict(lr=1e-3, warmup_steps=2, total_steps=20)
    jt = JTrainer(JModel(_tiny(jget_config, dtype=dtype)),
                  jopt.OptConfig(**hp),
                  JTrainerConfig(total_steps=20, log_every=1000))
    jt.fit(jax.random.PRNGKey(0),
           jdata.SyntheticTokens(64, seed=0).batches(8, 16))
    t = _trainer(dtype=dtype)
    t.fit(tr.PRNGKey(0), _loader(64))
    assert [h["step"] for h in t.history] == list(range(1, 21))
    d = [abs(a["loss"] - b["loss"]) for a, b in zip(jt.history, t.history)]
    assert len(d) == 20 and max(d) < tol, d
    assert all(h["grad_norm"] > 0 for h in t.history)


def test_loss_decreases():
    t = _trainer(total=60, lr=3e-3, warmup_steps=5, total_steps=60,
                 weight_decay=0.0)
    t.fit(tr.PRNGKey(0), _loader(64))
    first = np.mean([h["loss"] for h in t.history[:5]])
    last = np.mean([h["loss"] for h in t.history[-5:]])
    assert last < first - 0.3, (first, last)


def test_fault_injection_recovers(tmp_path):
    t = _trainer(tmp_path, total=30, total_steps=30)
    fired = {"n": 0}

    def fault(step):
        if step == 12 and fired["n"] == 0:
            fired["n"] = 1
            raise RuntimeError("injected node failure")

    params, opt_state = t.fit(tr.PRNGKey(0), _loader(64), fault_hook=fault)
    assert fired["n"] == 1
    assert int(opt_state.step) == 30          # completed despite the fault
    # restarted from the step-10 checkpoint: steps 11 and 12 ran twice
    assert [h["step"] for h in t.history][10:14] == [11, 12, 11, 12]
    assert t.ckpt._thread is None             # no writer left running


def test_fault_past_max_restarts_raises_without_a_writer(tmp_path):
    t = _trainer(tmp_path, total=10)
    t.tcfg.max_restarts = 1

    def fault(step):      # at the step the checkpoint restores to
        if step == 5:
            raise RuntimeError("injected node failure")

    with pytest.raises(RuntimeError, match="injected"):
        t.fit(tr.PRNGKey(0), _loader(64), fault_hook=fault)
    assert t.ckpt._thread is None
    assert ckpt.latest_step(str(tmp_path)) == 5


def test_kill_resume_continues_from_checkpoint(tmp_path):
    """Run 1 stops at step 10; run 2 ("a new process") resumes there and
    trains to 20 on the batches an uninterrupted run sees there: its
    params and optimizer state equal the uninterrupted run's bit for bit."""
    t1 = _trainer(tmp_path, total=10)
    t1.fit(tr.PRNGKey(0), _loader(64))
    t2 = _trainer(tmp_path, total=20)
    params, opt_state = t2.fit(tr.PRNGKey(0), _loader(64, skip=10))
    assert int(opt_state.step) == 20
    assert t2.history[0]["step"] == 11        # continued, not restarted
    t3 = _trainer(total=20)
    want = t3.fit(tr.PRNGKey(0), _loader(64))
    for g, w in zip(_state_leaves(params, opt_state), _state_leaves(*want)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert [h["loss"] for h in t2.history] == \
        [h["loss"] for h in t3.history[10:]]


def test_family_kill_resume_continues_from_checkpoint(tmp_path):
    """The same for the hybrid (zamba2 at the smoke width, bf16, float32
    SSM leaves among bf16 ones): run 2 resumes at step 11 and ends on the
    uninterrupted run's state, bit for bit."""
    cfg = get_config("zamba2-1.2b").smoke()
    hp = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)

    def run(total, ckdir=None, skip=0):
        it = data.SyntheticTokens(cfg.vocab, seed=0).batches(4, 32)
        for _ in range(skip):
            next(it)
        t = Trainer(Model(cfg, CPU), hp, TrainerConfig(
            total_steps=total, ckpt_every=5, log_every=1000,
            ckpt_dir=None if ckdir is None else str(ckdir)))
        return t, t.fit(tr.PRNGKey(0), it)

    run(10, tmp_path)
    t2, (params, opt_state) = run(20, tmp_path, skip=10)
    assert int(opt_state.step) == 20
    assert t2.history[0]["step"] == 11
    t3, want = run(20)
    for g, w in zip(_state_leaves(params, opt_state), _state_leaves(*want),
                    strict=True):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert [h["loss"] for h in t2.history] == \
        [h["loss"] for h in t3.history[10:]]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def _port_state(dtype="bfloat16", seed=0):
    m = Model(_tiny(get_config, dtype=dtype), CPU)
    p = m.init_params(tr.PRNGKey(seed))
    o = opt.init_opt_state(p)
    o = o._replace(step=torch.tensor(7, dtype=torch.int32))
    for x in leaves(o.mu):
        x.normal_()
    return p, o


def test_checkpoint_round_trip_tmp_and_retention(tmp_path):
    p, o = _port_state()
    d = str(tmp_path)
    for s in (5, 10, 15, 20):
        ckpt.save(d, s, (p, o), keep=3)
    assert sorted(os.listdir(d)) == [f"step_{s:08d}" for s in (10, 15, 20)]
    os.makedirs(os.path.join(d, "step_00000099.tmp"))   # a cut save
    assert ckpt.latest_step(d) == 20
    (p2, o2), step = ckpt.restore(d, (p, o))
    assert step == 20 and type(p2) is type(p) and p2 is not p
    for g, w in zip(_state_leaves(p2, o2), _state_leaves(p, o)):
        assert g.dtype == w.dtype and torch.equal(g, w)
    with open(os.path.join(d, "step_00000020", "manifest.json")) as f:
        man = json.load(f)
    assert man["step"] == 20
    assert man["leaves"][0] == {"name": "[0]['embed']['tok']",
                                "file": "leaf_00000.npy",
                                "shape": [64, 32], "dtype": "bfloat16"}
    assert man["leaves"][-1]["name"] == "[1].step"
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "none"), (p, o))


def test_async_checkpoint_snapshots_before_returning(tmp_path):
    p, o = _port_state()
    before = [x.clone() for x in _state_leaves(p, o)]
    ck = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    release = threading.Event()
    save = ckpt._write

    def slow_write(*a, **k):
        release.wait(10)
        return save(*a, **k)

    ckpt._write = slow_write
    try:
        ck.save_async(3, (p, o))
        with torch.no_grad():        # the next step updates in place
            for x in leaves(p.tree()) + leaves(o.master):
                x.add_(1)
        release.set()
        ck.wait()
    finally:
        ckpt._write = save
    assert ck._thread is None
    (p2, o2), step = ckpt.restore(str(tmp_path), (p, o))
    assert step == 3
    for g, w in zip(_state_leaves(p2, o2), before):
        assert torch.equal(g, w)


def test_async_checkpoint_surfaces_errors(tmp_path):
    p, o = _port_state()
    (tmp_path / "file").write_text("")
    ck = ckpt.AsyncCheckpointer(str(tmp_path / "file"), keep=2)
    ck.save_async(1, (p, o))
    with pytest.raises(OSError):
        ck.wait()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoints_cross_packages(tmp_path, dtype):
    """A JAX-written checkpoint restores in the port and a port-written
    one in the JAX package: the same names, arrays and bf16 bits."""
    jm = JModel(_tiny(jget_config, dtype=dtype))
    _cross_package_round_trip(tmp_path, jm, _port_state(dtype, seed=2))


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_checkpoints_cross_packages_families(tmp_path, arch):
    """The same for a MoE, the hybrid (float32 leaves in a bf16 tree) and
    the encdec tree at the smoke width, in bfloat16."""
    jm = JModel(jget_config(arch).smoke())
    p = Model(get_config(arch).smoke(), CPU).init_params(tr.PRNGKey(2))
    o = opt.init_opt_state(p)
    for x in leaves(o.mu):
        x.normal_()
    _cross_package_round_trip(tmp_path, jm, (p, o))


def _cross_package_round_trip(tmp_path, jm, port_state):
    """JAX → port and port → JAX through each package's checkpoints: the
    JAX package's ``PRNGKey(1)`` state (step 9, moments shifted) restored
    into ``port_state``'s structure, ``port_state`` restored into the JAX
    package's, and both manifests naming the same leaves."""
    jp = jm.init_params(jax.random.PRNGKey(1))
    jo = jopt.init_opt_state(jp)._replace(step=jnp.asarray(9, jnp.int32))
    jo = jo._replace(mu=jax.tree.map(lambda x: x + 0.5, jo.mu))
    jckpt.save(str(tmp_path / "jax"), 9, (jp, jo))
    p, o = port_state
    (p2, o2), step = ckpt.restore(str(tmp_path / "jax"), (p, o))
    assert step == 9 and int(o2.step) == 9
    for g, w in zip(_state_leaves(p2, o2), jax.tree.leaves((jp, jo)),
                    strict=True):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(),
                                          w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)

    ckpt.save(str(tmp_path / "port"), 4, (p, o))
    (jp2, jo2), jstep = jckpt.restore(str(tmp_path / "port"), (jp, jo))
    assert jstep == 4
    for g, w in zip(jax.tree.leaves((jp2, jo2)), _state_leaves(p, o),
                    strict=True):
        g = np.asarray(g)
        assert str(g.dtype) == str(w.dtype).split(".")[1]
        if w.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(np.int16),
                                          w.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(g, w.numpy())
    names = []
    for sub in ("jax", "port"):
        step = jckpt.latest_step(str(tmp_path / sub))
        with open(tmp_path / sub / f"step_{step:08d}" / "manifest.json") as f:
            names.append([(e["name"], e["shape"], e["dtype"])
                          for e in json.load(f)["leaves"]])
    assert names[0] == names[1]


def test_opt_state_round_trip_through_numpy():
    jm = JModel(_tiny(jget_config))
    jp = jm.init_params(jax.random.PRNGKey(0))
    jo = jopt.init_opt_state(jp)
    o = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo), CPU)
    back = convert.opt_state_to_numpy(o)
    assert back.step.dtype == np.int32
    for g, w in zip(jax.tree.leaves(tuple(back)), jax.tree.leaves(jo)):
        np.testing.assert_array_equal(g, np.asarray(w))
    p = convert.lm_params_from_numpy(jax.tree.map(np.asarray, jp),
                                     jm.cfg, CPU)
    tree = convert.lm_params_to_numpy(p)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for g, w in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(jnp.asarray(g, w.dtype), w)


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

def test_synthetic_tokens_equal_reference():
    want = jdata.SyntheticTokens(1000, seed=3).batches(4, 33)
    got = data.SyntheticTokens(1000, seed=3).batches(4, 33)
    for _ in range(3):
        w, g = next(want), next(got)
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype == np.int32
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("bipartite", [False, True])
def test_graph_walk_corpus_equals_reference(bipartite):
    jg, _, _ = jpaysim_like(n=512, n_edges=2000)
    g, _, _ = paysim_like(n=512, n_edges=2000)
    if bipartite:   # the same edges read as a 512 x 512 bipartite graph
        jg = type(jg)(jg.src, jg.dst, 512, 512, True)
        g = type(g)(g.src, g.dst, 512, 512, True)
    want = jdata.GraphWalkCorpus(jg, vocab=600, seed=4)
    got = data.GraphWalkCorpus(g, vocab=600, seed=4)
    np.testing.assert_array_equal(got.walk(16, 8), want.walk(16, 8))
    wb, gb = want.batches(4, 32), got.batches(4, 32)
    for _ in range(2):
        w, b = next(wb), next(gb)
        for k in ("tokens", "labels"):
            assert b[k].dtype == np.int32
            np.testing.assert_array_equal(b[k], w[k])


def test_sharded_loader_slices_per_rank():
    src = data.SyntheticTokens(vocab=64, seed=0)
    ld = data.ShardedLoader(src, batch=16, seq=8, process_index=1,
                            process_count=4)
    b = next(ld)
    assert b["tokens"].shape == (4, 8)          # 16 / 4 ranks
    assert (ld.pi, ld.pc) == (1, 4)
    whole = data.ShardedLoader(data.SyntheticTokens(vocab=64, seed=0),
                               batch=16, seq=8)
    assert (whole.pi, whole.pc, whole.local_batch) == (0, 1, 16)
    np.testing.assert_array_equal(
        next(whole)["tokens"],
        next(jdata.SyntheticTokens(64, seed=0).batches(16, 8))["tokens"])
    with pytest.raises(ValueError):
        data.ShardedLoader(src, batch=10, seq=8, process_count=4)


def test_prefetcher_copies_batches_onto_the_device():
    want = _loader(64)
    pf = data.Prefetcher(_loader(64), size=2, device=CPU)
    for _ in range(3):
        b, w = next(pf), next(want)
        for k in ("tokens", "labels"):
            assert isinstance(b[k], torch.Tensor) and b[k].device.type == "cpu"
            np.testing.assert_array_equal(b[k].numpy(), w[k])

    def two():
        yield from (next(_loader(64)), next(_loader(64)))
    assert len(list(data.Prefetcher(two()))) == 2

    def broken():
        yield next(_loader(64))
        raise KeyError("bad shard")
    pf = data.Prefetcher(broken())
    next(pf)
    with pytest.raises(KeyError):
        next(pf)


# ---------------------------------------------------------------------------
# the fifth example
# ---------------------------------------------------------------------------

ARGS = ["--steps", "4", "--vocab", "256", "--d-model", "64", "--layers",
        "2", "--seq", "32", "--batch", "4"]


def test_train_lm_on_graph_corpus_matches_reference(tmp_path, monkeypatch,
                                                    capsys):
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_on_graph_corpus.py"
    spec = importlib.util.spec_from_file_location("jax_train_example", path)
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    monkeypatch.setattr(sys, "argv", ["x", *ARGS, "--ckpt",
                                      str(tmp_path / "jax")])
    jex.main()
    want = capsys.readouterr().out

    from repro_torch.examples import train_lm_on_graph_corpus as ex
    out = ex.main([*ARGS, "--ckpt", str(tmp_path / "port"),
                   "--device", "cpu"])
    got = capsys.readouterr().out

    def lines(text, prefix):
        return [ln for ln in text.splitlines() if ln.startswith(prefix)]
    # the same generated graph and model size
    assert lines(got, "generated graph") == lines(want, "generated graph")
    assert lines(got, "model:") == lines(want, "model:")
    # the same graph's edges and corpus tokens
    from repro.core.pipeline import SyntheticGraphPipeline as JPipe
    jg, cont, cat = jpaysim_like(n=256, n_edges=6 * 256)
    jpipe = JPipe(struct="kronecker", features="random", aligner="random",
                  gan_steps=0)
    jpipe.fit(jg, cont, cat)
    jsyn, _, _ = jpipe.generate(seed=0)
    g = out["graph"]
    np.testing.assert_array_equal(g.src.numpy(), np.asarray(jsyn.src))
    np.testing.assert_array_equal(g.dst.numpy(), np.asarray(jsyn.dst))
    jb = next(jdata.GraphWalkCorpus(jsyn, vocab=256).batches(4, 32))
    b = next(data.GraphWalkCorpus(g, vocab=256).batches(4, 32))
    np.testing.assert_array_equal(b["tokens"], jb["tokens"])
    # the first steps' losses, from the printed means
    (jl,), (pl,) = lines(want, "loss:"), lines(got, "loss:")
    jf = float(jl.split("first10=")[1].split()[0])
    pf = float(pl.split("first10=")[1].split()[0])
    assert abs(jf - pf) < 1e-2, (jl, pl)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    # the final checkpoint, resumed by a rerun that has nothing left to do
    assert ckpt.latest_step(str(tmp_path / "port")) == 4


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "rwkv6-7b"])
def test_train_lm_on_graph_corpus_other_families(tmp_path, monkeypatch,
                                                 capsys, arch):
    """The example's ``--arch`` with a MoE and an RWKV6 config: the same
    model size and first losses (within 1e-2, as above) as the JAX
    package's example at the same arguments."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "train_lm_on_graph_corpus.py"
    spec = importlib.util.spec_from_file_location("jax_train_example", path)
    jex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jex)
    args = [*ARGS, "--arch", arch]
    monkeypatch.setattr(sys, "argv", ["x", *args, "--ckpt",
                                      str(tmp_path / "jax")])
    jex.main()
    want = capsys.readouterr().out

    from repro_torch.examples import train_lm_on_graph_corpus as ex
    out = ex.main([*args, "--ckpt", str(tmp_path / "port"), "--device",
                   "cpu"])
    got = capsys.readouterr().out

    def lines(text, prefix):
        return [ln for ln in text.splitlines() if ln.startswith(prefix)]
    assert lines(got, "generated graph") == lines(want, "generated graph")
    assert lines(got, "model:") == lines(want, "model:")
    assert arch in lines(got, "model:")[0]
    assert out["trainer"].model.cfg.family == \
        get_config(arch).family != "dense"
    (jl,), (pl,) = lines(want, "loss:"), lines(got, "loss:")
    jf = float(jl.split("first10=")[1].split()[0])
    pf = float(pl.split("first10=")[1].split()[0])
    assert abs(jf - pf) < 1e-2, (jl, pl)
    assert len(out["losses"]) == 4 and np.isfinite(out["losses"]).all()
    assert ckpt.latest_step(str(tmp_path / "port")) == 4
