"""Training of the non-dense families in the port alone, on the CPU, at
each config's ``smoke()`` width: remat of the RWKV, hybrid (Mamba and
shared attention) and encdec blocks, the microbatched step over batches
with patches and frames, and ``input_specs(kind="train")`` against the
JAX package's.

Tolerances: remat on against off, equal bit for bit (the recompute runs
the same ops on the same inputs); M = 2 against M = 1, the reference's
own bounds for it (``test_microbatch_equivalence``: loss 1e-4, masters
1e-5)."""
import numpy as np
import pytest
import torch

from _torch_families_common import (CPU, HP, NEW_ARCHS,  # noqa: F401
                                    CountWeightProducts, _one_thread,
                                    batch_for, cfgs, tb)
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.models import Model as JModel
from repro_torch import random as tr
from repro_torch.configs.base import ShapeSpec
from repro_torch.models import Model, encdec, transformer
from repro_torch.models.params import leaves
from repro_torch.training import optimizer as opt
from repro_torch.training.steps import make_train_step

#: each family's blocks: (module, function name) of every block that runs
#: under remat, and how many times a forward calls it at the smoke width
BLOCKS = {
    "rwkv6-7b": [(transformer, "_rwkv_block", 2)],
    "zamba2-1.2b": [(transformer, "_mamba_layer", 4),
                    (transformer, "_shared_attn_block", 2)],
    "seamless-m4t-medium": [(encdec, "_encoder_block", 2),
                            (encdec, "_decoder_block", 2)],
}


@pytest.mark.parametrize("policy", ["nothing", "dots"])
@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_remat_matches_no_remat(arch, policy, monkeypatch):
    _, cfg = cfgs(arch, remat_policy=policy)
    b = tb(batch_for(cfg, B=2, S=32, seed=4))
    runs = {}
    for remat in (False, True):
        m = Model(cfg.replace(remat=remat), CPU)
        p = m.init_params(tr.PRNGKey(0))
        calls = {}
        for mod, name, _ in BLOCKS[arch]:
            block = getattr(mod, name)
            monkeypatch.setattr(
                mod, name, lambda *a, _b=block, _n=name, **k:
                calls.update({_n: calls.get(_n, 0) + 1}) or _b(*a, **k))
        ws = leaves(p.tree())
        for w in ws:
            w.requires_grad_(True)
        loss = m.loss(p, b)
        counter = CountWeightProducts()
        with counter:
            grads = torch.autograd.grad(loss, ws)
        monkeypatch.undo()
        runs[remat] = (loss, grads, calls, counter.n)
    (l0, g0, c0, mm0), (l1, g1, c1, mm1) = runs[False], runs[True]
    assert torch.equal(l0, l1)
    for a, c in zip(g0, g1):
        assert torch.equal(a, c)
    # remat reruns each block's forward in the backward; "dots" keeps the
    # weight products' outputs, so the rerun computes none of them again
    for _, name, n in BLOCKS[arch]:
        assert (c0[name], c1[name]) == (n, 2 * n), name
    assert (mm1 > mm0) == (policy != "dots"), (mm0, mm1)


@pytest.mark.parametrize("arch", sorted(BLOCKS))
def test_remat_keeps_inference_paths(arch, monkeypatch):
    """Without gradients (scoring), and with a cache (prefill, decode),
    no block runs under remat, even with weights that take gradients."""
    _, cfg = cfgs(arch)
    m = Model(cfg, CPU)
    p = m.init_params(tr.PRNGKey(0))
    b = tb(batch_for(cfg, B=2, S=32, seed=4))
    b.pop("labels")
    want = m.forward(p, b).logits
    for w in leaves(p.tree()):
        w.requires_grad_(True)

    def refuse(*a, **k):
        raise AssertionError("remat on an inference path")

    monkeypatch.setattr(transformer.ckpt, "checkpoint", refuse)
    with torch.no_grad():
        got = m.forward(p, b).logits
    assert torch.equal(got, want) and not got.requires_grad
    cache = (encdec.init_encdec_cache(cfg, 2, 32, b["frames"].shape[1],
                                      CPU)
             if cfg.family == "encdec" else m.init_cache(2, 32))
    logits, cache = m.prefill(p, b, cache)
    assert logits.shape == (2, cfg.vocab)


@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-medium"])
def test_microbatches_split_patches_and_frames(arch):
    """M = 2 against M = 1 in the port: each microbatch takes its half of
    the patches or frames along with its tokens."""
    _, cfg = cfgs(arch)
    b = batch_for(cfg, B=4, S=32, seed=6)
    hp = opt.OptConfig(lr=1e-3, warmup_steps=0)
    out = []
    for M in (1, 2):
        m = Model(cfg.replace(microbatches=M), CPU)
        p = m.init_params(tr.PRNGKey(0))
        out.append(make_train_step(m, hp)(p, opt.init_opt_state(p), b))
    (_, o1, r1), (_, o2, r2) = out
    assert abs(float(r1["loss"]) - float(r2["loss"])) < 1e-4
    d = max(float((a - c).abs().max())
            for a, c in zip(leaves(o1.master), leaves(o2.master)))
    assert d < 1e-5, d


@pytest.mark.parametrize("arch", ["pixtral-12b", "seamless-m4t-medium"])
def test_step_casts_float_inputs_to_the_params_dtype(arch):
    """A bf16 model's step gets float32 numpy patches or frames: the loss
    sees them in bf16 on the model's device, the tokens as int32."""
    _, cfg = cfgs(arch, dtype="bfloat16", microbatches=2)
    m = Model(cfg, CPU)
    seen = []
    loss = m.loss
    m.loss = lambda p, batch: seen.append(
        {k: v.dtype for k, v in batch.items()}) or loss(p, batch)
    p = m.init_params(tr.PRNGKey(0))
    b = batch_for(cfg, B=4, S=32, seed=6)
    _, _, met = make_train_step(m, opt.OptConfig(**HP))(
        p, opt.init_opt_state(p), b)
    extra = "patches" if cfg.family == "vlm" else "frames"
    assert len(seen) == 2 and all(
        s == {"tokens": torch.int32, "labels": torch.int32,
              extra: torch.bfloat16} for s in seen), seen
    assert np.isfinite(float(met["loss"]))


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_train_input_specs_match_reference(arch):
    jcfg, cfg = cfgs(arch, dtype="bfloat16")
    want = JModel(jcfg).input_specs(JShapeSpec("x", 256, 4, "train"))
    m = Model(cfg, CPU)
    got = m.input_specs(ShapeSpec("x", 256, 4, "train"))
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        assert str(got[k].dtype).split(".")[1] == str(want[k].dtype), k
    assert m.batch_dims(got) == JModel(jcfg).batch_dims(want)
