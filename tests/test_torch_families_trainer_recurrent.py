"""20 ``Trainer`` steps of RWKV6 and the hybrid Mamba2 against the JAX
package's, on the CPU, at each config's ``smoke()`` width in float32
(``trainers_both``).

Both trainings are sensitive to the last bits of their start, in either
package, so the limits follow what a change of the initial weights by a
factor 1 + 1e-7 does to a package's own 20 losses (measured at these
settings):

* RWKV6: up to 1.05e-5 in the reference (9.5e-7 in the port), so the
  losses are held within 2e-5 (measured against the reference: 6.2e-6);
* the hybrid: the reference's own losses move by 1.4e-6 at step 1,
  3.9e-4 at step 2, 3.3e-3 at step 3 and up to 0.20 later (the port's by
  9.5e-7, 9.5e-7, 1.2e-4, up to 0.17).  So its first loss (the initial
  weights, no update yet) is held within 1e-5 and its second within 1e-3
  (measured against the reference: 4.8e-7, 3.8e-6; then 3.8e-5 at step 3
  and up to 0.13).  After them two runs of one package part as much as
  the two packages do; every loss and grad norm is held finite."""
from _torch_families_common import _one_thread, trainers_both  # noqa: F401


def test_rwkv_trainer_follows_reference():
    want, got = trainers_both("rwkv6-7b")
    d = [abs(a["loss"] - b["loss"]) for a, b in zip(want, got)]
    assert len(d) == 20 and max(d) < 2e-5, d


def test_hybrid_trainer_follows_reference():
    want, got = trainers_both("zamba2-1.2b")
    d = [abs(a["loss"] - b["loss"]) for a, b in zip(want, got)]
    assert len(d) == 20 and d[0] < 1e-5 and d[1] < 1e-3, d
