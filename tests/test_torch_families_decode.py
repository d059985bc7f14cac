"""The port's other LM families against the JAX package, on the CPU:
prefill + decode through each family's cache, at each config's
``smoke()`` width (the tolerances of ``test_torch_families.py``).
"""
import numpy as np
import pytest

from repro.models import Model as JModel
from repro_torch.models import Model

from _torch_families_common import (CPU, NEW_ARCHS,  # noqa: F401
                                    _one_thread, cfgs, f32, jb, jparams_f32,
                                    logit_tol, port, tb)


def _prefill_batch(cfg, toks, seed=6):
    """The prompt's extra inputs: VLM patches, encdec frames (8)."""
    rng = np.random.default_rng(seed)
    B = toks.shape[0]
    if cfg.family == "vlm":
        return {"patches": rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_dim)).astype(np.float32)}
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, 8, cfg.d_model)).astype(np.float32)}
    return {}


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_prefill_decode_matches_full_forward(arch):
    """prefill(t[:S]) + decode(t[S]): the port's logits against the
    reference's same two steps, and against the full forward at S (the
    MoE only where no token was dropped: llama4's top-1 at the smoke
    width drops tokens in the full forward's groups, not in decode's)."""
    jcfg, cfg = cfgs(arch)
    jm, m = JModel(jcfg), Model(cfg, CPU)
    jp = jparams_f32(arch)
    params = port(jp, cfg)
    B, S = 2, 16
    toks = np.random.default_rng(5).integers(0, cfg.vocab, (B, S + 1),
                                             dtype=np.int32)
    extra = _prefill_batch(cfg, toks)
    n = S + 1 + (cfg.vlm.n_patches if cfg.family == "vlm" else 0)
    seq = 2 * n if cfg.family == "encdec" else n

    jcache = jm.init_cache(B, seq)
    _, jcache = jm.prefill(jp, jb({"tokens": toks[:, :S], **extra}), jcache)
    want = jm.forward(jp, jb({"tokens": toks[:, S:]}), cache=jcache).logits

    cache = m.init_cache(B, seq)
    _, cache = m.prefill(params, tb({"tokens": toks[:, :S], **extra}),
                         cache)
    assert cache["pos"] == n - 1
    got = m.forward(params, tb({"tokens": toks[:, S:]}), cache=cache)
    np.testing.assert_allclose(f32(got.logits), f32(want), **logit_tol(cfg))
    assert got.cache["pos"] == n
    full = m.forward(params, tb({"tokens": toks, **extra})).logits
    if arch != "llama4-scout-17b-16e":
        np.testing.assert_allclose(f32(got.logits[:, 0]), f32(full[:, -1]),
                                   **logit_tol(cfg))
