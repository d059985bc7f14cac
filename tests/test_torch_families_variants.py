"""The port's other LM families against the JAX package, on the CPU:
the list-form stacks (``scan_layers=False``), at each config's
``smoke()`` width (the tolerances of ``test_torch_families.py``).
"""
import jax
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro_torch.models import Model

from _torch_families_common import (CPU, NEW_ARCHS,  # noqa: F401
                                    _one_thread, batch_for, cfgs, f32, jb,
                                    jparams_f32, logit_tol, port, tb)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_scan_layers_false_matches(arch):
    """``scan_layers=False``: on the list-form tree (the reference's own
    draw for that form) the logits match the reference's; on the stacked
    tree they equal the stacked forward's, bit for bit."""
    jcfg, cfg = cfgs(arch, scan_layers=False)
    jp = JModel(jcfg).init_params(jax.random.PRNGKey(2))
    b = batch_for(cfg, seed=5)
    want = JModel(jcfg).forward(jp, jb(b)).logits
    got = Model(cfg, CPU).forward(port(jp, cfg), tb(b)).logits
    np.testing.assert_allclose(f32(got), f32(want), **logit_tol(cfg))

    stacked = port(jparams_f32(arch), cfg.replace(scan_layers=True))
    a = Model(cfg.replace(scan_layers=True), CPU).forward(stacked, tb(b))
    c = Model(cfg, CPU).forward(stacked, tb(b))
    assert torch.equal(a.logits, c.logits)
