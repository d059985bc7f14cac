"""ROADMAP C17: the hybrid's gradients at its published SSD chunk.

The reference's ``mamba_block`` takes ``exp`` over the whole (Q, Q)
chunk and masks the upper triangle after it; at a chunk of 128 that
triangle overflows float32 and the backward multiplies the mask's zero
by inf.  The port masks to −inf before the ``exp``, a departure made on
purpose.  At zamba2's smoke width in float32, over 2 x 128 tokens, with
``ssm.chunk`` 16 and 128: the port's loss equals the reference's (1e-6
relative), its gradients equal the reference's at 16 (``grad_tol``), and
at 128 every gradient of the port is finite, where the reference's are
not."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_families_common import (_one_thread, batch_for, cfgs, f32,  # noqa: F401
                                    grad_tol, jb, jparams_f32, port, tb)
from repro.models import Model as JModel
from repro_torch.models import Model
from repro_torch.models.params import leaves

ARCH = "zamba2-1.2b"


@pytest.mark.parametrize("chunk", [16, 128])
def test_hybrid_gradients_at_chunk(chunk):
    jcfg, cfg = cfgs(ARCH)
    jcfg, cfg = (c.replace(ssm=dataclasses.replace(c.ssm, chunk=chunk))
                 for c in (jcfg, cfg))
    jp = jparams_f32(ARCH)
    b = batch_for(cfg, B=2, S=128, seed=9)
    jloss, jgrads = jax.jit(jax.value_and_grad(JModel(jcfg).loss))(
        jp, jb(b))
    p = port(jp, cfg)
    ws = leaves(p.tree())
    for w in ws:
        w.requires_grad_(True)
    loss = Model(cfg, "cpu").loss(p, tb(b))
    grads = torch.autograd.grad(loss, ws)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-6)
    want = jax.tree.leaves(jgrads)
    assert [tuple(g.shape) for g in grads] == [w.shape for w in want]
    for g in grads:
        assert bool(g.isfinite().all())
    bad = sum(int((~np.isfinite(f32(w))).sum()) for w in want)
    if chunk == 16:
        assert bad == 0
        for g, w in zip(grads, want):
            np.testing.assert_allclose(f32(g), f32(w), rtol=0,
                                       atol=grad_tol(cfg, w))
    else:
        assert bad > 0      # the reference's fault, which the port departs from
