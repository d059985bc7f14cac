"""One train step of the MoE, VLM and encdec families against the JAX
package's, on the CPU, at each config's ``smoke()`` width in float32.

The same weights (the reference's ``PRNGKey(0)`` draw, carried across)
and a numpy-seeded batch (patches or frames where the family takes them)
go through the reference's jitted ``make_train_step`` and the port's;
both hand on their float32 gradients (``capture_grads``).  Tolerances
(``check_step``): loss and ``grad_norm`` within 1e-6 relative (the same sums in another
order); every gradient present, finite and within 5e-5; the masters
within 5e-5 where the reference's gradient is at least 1e-5, else within
2·lr (Adam's first update, ``check_step``).  The hybrid and RWKV6 are in
``test_torch_families_train_recurrent.py``."""
import pytest
import torch

from _torch_families_common import (CPU, _one_thread, batch_for,  # noqa: F401
                                    cfgs, check_step, jparams_f32, port,
                                    step_both)
from repro_torch.models import Model, transformer
from repro_torch.models.params import leaves


@pytest.mark.parametrize("arch,M", [
    ("qwen3-moe-30b-a3b", 1), ("qwen3-moe-30b-a3b", 2),
    ("llama4-scout-17b-16e", 1), ("pixtral-12b", 1),
    ("seamless-m4t-medium", 1)])
def test_train_step_matches_reference(arch, M, monkeypatch):
    check_step(*step_both(arch, monkeypatch, M))


def test_moe_aux_loss_reaches_the_router(monkeypatch):
    """The router's gradient holds the load-balance term: without
    ``0.01 · aux`` in the loss it differs (both packages), and the
    dropped slots take none (capacity 1 drops most of them)."""
    arch = "qwen3-moe-30b-a3b"
    _, cfg = cfgs(arch)
    b = batch_for(cfg, B=4, S=32, seed=5)
    p = port(jparams_f32(arch), cfg)
    m = Model(cfg, CPU)
    tb = {k: torch.from_numpy(v) for k, v in b.items()}

    def gate_grad(aux_weight):
        ws = leaves(p.tree())
        for w in ws:
            w.requires_grad_(True)
        out = m.forward(p, tb)
        loss = transformer.loss_from_logits(out.logits, tb, cfg, 0.0) + \
            aux_weight * out.aux_loss
        return torch.autograd.grad(loss, p.p.layers.moe.gate)[0]

    with_aux, without = gate_grad(0.01), gate_grad(0.0)
    assert float((with_aux - without).abs().max()) > 1e-6
    # capacity 1 a expert and group: most slots are dropped, and the step
    # is still finite and equal to the reference's
    moe = cfg.moe.__class__(**{**cfg.moe.__dict__, "capacity_factor": 0.1})
    check_step(*step_both(arch, monkeypatch, moe=moe))
