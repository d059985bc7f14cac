"""The port's other LM families against the JAX package, on the CPU:
bfloat16 losses at each config's ``smoke()`` width, within 2e-2 (the two
frameworks round bf16 at other places).
"""
import jax
import pytest
import torch

from repro.models import Model as JModel
from repro_torch.models import Model

from _torch_families_common import (CPU, NEW_ARCHS,  # noqa: F401
                                    _one_thread, batch_for, cfgs, jb, port,
                                    tb)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_loss_matches_reference_bf16(arch):
    jcfg, cfg = cfgs(arch, "bfloat16")
    jp = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    b = batch_for(cfg, seed=4)
    jloss = JModel(jcfg).loss(jp, jb(b))
    loss = Model(cfg, CPU).loss(port(jp, cfg), tb(b))
    assert loss.dtype == torch.float32
    assert abs(float(loss) - float(jloss)) < 2e-2
