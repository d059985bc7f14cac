"""The port's serving engine against the JAX package's, on the CPU, at
the smoke width in float32: what a slot holds after a prefill, and after
slots are reused (ROADMAP C13, C16).
"""
import numpy as np
import pytest
import torch

from repro.models import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.models import Model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_families_common import (CPU, LENGTHS,  # noqa: F401
                                    _one_thread, cfgs, jparams_f32, port,
                                    make_prompts, tb)


def test_engine_writes_prefilled_states_into_the_slot():
    """After a slot's prefill, the engine's cache holds the prompt's
    final WKV state and shifts in that slot, and the other slot is left
    as it was."""
    _, cfg = cfgs("rwkv6-7b")
    m = Model(cfg, CPU)
    params = port(jparams_f32("rwkv6-7b"), cfg)
    eng = ServingEngine(m, params, 2, 32)
    before = {k: v.clone() for k, v in eng.cache.items() if k != "pos"}
    p = make_prompts(cfg, (9,), seed=8)[0]
    eng._prefill_slot(p[None], 1)
    _, alone = m.prefill(params, tb({"tokens": p[None]}),
                         m.init_cache(1, 32))
    for k in ("wkv", "shift_tm", "shift_cm"):
        assert torch.equal(eng.cache[k][:, 1:2], alone[k]), k
        assert torch.equal(eng.cache[k][:, 0], before[k][:, 0]), k


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "rwkv6-7b"])
def test_engine_caches_match_reference_after_slot_reuse(arch):
    """ROADMAP C16: a reused slot's prefill starts from the recurrent
    state its last request left (the chunked scan's initial state and
    RWKV's shifts), in the reference's engine and in the port's.  After
    both engines served the same six requests through two slots, every
    tensor of their caches is equal within 1e-5 (the hybrid's 1e-4: its
    deeper layers' inputs carry the SSD chunks' float32 spread, see
    ``logit_tol``)."""
    jcfg, cfg = cfgs(arch)
    jp = jparams_f32(arch)
    prompts = make_prompts(cfg, LENGTHS, seed=9)
    jeng = JServingEngine(JModel(jcfg), jp, 2, 40)
    jeng.run([JRequest(i, p, max_new=4) for i, p in enumerate(prompts)])
    eng = ServingEngine(Model(cfg, CPU), port(jp, cfg), 2, 40)
    eng.run([Request(i, p, max_new=4) for i, p in enumerate(prompts)])
    assert sorted(eng.cache) == sorted(jeng.cache)
    tol = 1e-4 if cfg.family == "hybrid" else 1e-5
    for k, want in jeng.cache.items():
        if k != "pos":
            np.testing.assert_allclose(eng.cache[k].numpy(),
                                       np.asarray(want), rtol=0, atol=tol,
                                       err_msg=k)
