"""One train step of the hybrid Mamba2 (zamba2) and RWKV6 families
against the JAX package's, on the CPU, at each config's ``smoke()``
width in float32: autograd through ``mamba_block``'s and ``time_mix``'s
chunk loops and the token shifts, the blocks under remat.  RWKV6 also
at its published chunk of 32, where its decay clamp keeps ``exp(±cum)``
within float32 (``models/rwkv.py``).  Tolerances as
``test_torch_families_train_step.py``'s (``check_step``); the hybrid's
gradients within ``grad_tol``'s 1e-3.  Its published chunk of 128 is
``test_torch_families_train_c17.py``'s."""
import dataclasses

import pytest

from _torch_families_common import (_one_thread, cfgs, check_step,  # noqa: F401
                                    step_both)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_train_step_matches_reference(arch, monkeypatch):
    check_step(*step_both(arch, monkeypatch))


def test_rwkv_train_step_at_published_chunk(monkeypatch):
    """Two chunks of 32 (``rwkv6_7b.py``'s chunk) in each sequence."""
    _, cfg = cfgs("rwkv6-7b")
    rwkv = dataclasses.replace(cfg.rwkv, chunk=32)
    check_step(*step_both("rwkv6-7b", monkeypatch, S=64, rwkv=rwkv))
