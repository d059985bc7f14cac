"""20 ``Trainer`` steps of the MoE, VLM and encdec families against the
JAX package's, on the CPU, at each config's ``smoke()`` width in
float32, over loaders that yield patches or frames where the family
takes them (``trainers_both``).  Losses per step within 1e-5, as
``tests/test_torch_trainer.py`` holds the dense LM's (sums in another
order).  The hybrid and RWKV6 are in
``test_torch_families_trainer_recurrent.py``."""
import pytest

from _torch_families_common import _one_thread, trainers_both  # noqa: F401


@pytest.mark.parametrize("arch", ["qwen3-moe-30b-a3b", "pixtral-12b",
                                  "seamless-m4t-medium"])
def test_trainer_follows_reference(arch):
    want, got = trainers_both(arch)
    d = [abs(a["loss"] - b["loss"]) for a, b in zip(want, got)]
    assert len(d) == 20 and max(d) < 1e-5, d
