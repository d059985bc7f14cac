"""The port's other LM families against the JAX package, on the CPU:
float32 logits and losses, and the VLM's patches and the encdec's frames
reaching the logits, at each config's ``smoke()`` width (the tolerances
of ``test_torch_families.py``).
"""
import numpy as np
import pytest

from repro.models import Model as JModel
from repro_torch.models import Model

from _torch_families_common import (CPU, NEW_ARCHS,  # noqa: F401
                                    _one_thread, batch_for, cfgs, f32, jb,
                                    jparams_f32, logit_tol, port, tb)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_forward_and_loss_match_reference_f32(arch):
    jcfg, cfg = cfgs(arch)
    jm, m = JModel(jcfg), Model(cfg, CPU)
    jp = jparams_f32(arch)
    b = batch_for(cfg)
    jout = jm.forward(jp, jb(b))
    jloss = jm.loss(jp, jb(b))
    params = port(jp, cfg)
    out = m.forward(params, tb(b))
    loss = m.loss(params, tb(b))
    assert out.logits.shape == jout.logits.shape
    np.testing.assert_allclose(f32(out.logits), f32(jout.logits),
                               **logit_tol(cfg))
    assert abs(float(loss) - float(jloss)) < 1e-5
    if cfg.family == "moe":
        assert abs(float(out.aux_loss) - float(jout.aux_loss)) < 1e-5


def test_vlm_patches_change_text_logits():
    _, cfg = cfgs("pixtral-12b")
    m = Model(cfg, CPU)
    params = port(jparams_f32("pixtral-12b"), cfg)
    b = tb(batch_for(cfg))
    l1 = m.forward(params, b).logits[:, cfg.vlm.n_patches:]
    l2 = m.forward(params, dict(b, patches=b["patches"] + 1.0)).logits[
        :, cfg.vlm.n_patches:]
    assert l1.shape[1] == b["tokens"].shape[1]
    assert float((l1 - l2).abs().max()) > 1e-4


def test_encdec_frames_change_logits():
    _, cfg = cfgs("seamless-m4t-medium")
    m = Model(cfg, CPU)
    params = port(jparams_f32("seamless-m4t-medium"), cfg)
    b = tb(batch_for(cfg))
    l1 = m.forward(params, b).logits
    l2 = m.forward(params, dict(b, frames=b["frames"] * 2)).logits
    assert float((l1 - l2).abs().max()) > 1e-4
