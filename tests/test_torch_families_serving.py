"""The port's other LM families against the JAX package, on the CPU:
the serving engine, at each config's ``smoke()`` width: served tokens
equal, exactly, in float32.
"""
import pytest

from repro.models import Model as JModel
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch.models import Model
from repro_torch.serving.engine import Request, ServingEngine

from _torch_families_common import (CPU, LENGTHS,  # noqa: F401
                                    _one_thread, cfgs, jparams_f32, port,
                                    make_prompts)


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "llama4-scout-17b-16e",
                                  "zamba2-1.2b", "rwkv6-7b"])
def test_serving_engine_matches_reference(arch):
    """Served tokens equal the JAX engine's: the SSM and WKV states of a
    slot's prefill are written back into the slot, as the reference's
    ``dynamic_update_slice_in_dim`` does, short conv buffers included."""
    jcfg, cfg = cfgs(arch)
    jp = jparams_f32(arch)
    prompts = make_prompts(cfg, LENGTHS, seed=7)
    want = JServingEngine(JModel(jcfg), jp, 2, 40).run(
        [JRequest(i, p, max_new=5) for i, p in enumerate(prompts)])
    eng = ServingEngine(Model(cfg, CPU), port(jp, cfg), 2, 40)
    got = eng.run([Request(i, p, max_new=5) for i, p in enumerate(prompts)])
    assert got == want
    assert sorted(got) == list(range(len(prompts)))
