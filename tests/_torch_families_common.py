"""Helpers shared by the LM-family parity tests (``test_torch_moe.py``,
``test_torch_ssm_rwkv.py``, ``test_torch_families*.py``): torch on one
thread, configs of both packages at the smoke width, a scoring batch per
family, and the JAX package's weights carried into the port."""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import Model as JModel
from repro.models.params import init_params as jinit_params
from repro_torch import convert
from repro_torch.configs import get_config

CPU = "cpu"


NEW_ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-16e", "pixtral-12b",
             "zamba2-1.2b", "rwkv6-7b", "seamless-m4t-medium"]


def logit_tol(cfg) -> dict:
    """float32 logits: 1e-4; the hybrid's 5e-4.  Its SSD chunks take exp
    of differences of cumulative sums and normalise small products, which
    float32 carries less closely than the other families' blocks: two
    float32 evaluations of the same forward (JAX and port, card and CPU)
    differ by up to ~2e-4 at the smoke width, where the other families'
    stay within 1e-5."""
    return dict(rtol=0, atol=5e-4 if cfg.family == "hybrid" else 1e-4)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one CPU thread: as fast here at these sizes, and no
    thread pool left spinning beside the suite's other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)


def cfgs(arch, dtype="float32", **kw):
    return tuple(get(arch).smoke().replace(dtype=dtype, **kw)
                 for get in (jget_config, get_config))


def f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def port(jparams, cfg):
    return convert.lm_params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        cfg, CPU)


def batch_for(cfg, B=2, S=32, seed=1):
    """A scoring batch as numpy: ``S`` positions in all (VLM: patches and
    text; encdec: frames and tokens, half each)."""
    rng = np.random.default_rng(seed)
    out = {}
    n = S
    if cfg.family == "vlm":
        n = S - cfg.vlm.n_patches
        out["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        n = S // 2
        out["frames"] = rng.standard_normal(
            (B, S - n, cfg.d_model)).astype(np.float32)
    out["tokens"] = rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)
    out["labels"] = rng.integers(0, cfg.vocab, (B, n), dtype=np.int32)
    return out


def jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


_JPARAMS = {}


def jparams_f32(arch):
    """The JAX package's float32 smoke weights of ``arch`` (key 0), made
    once per test process."""
    if arch not in _JPARAMS:
        jcfg, _ = cfgs(arch)
        _JPARAMS[arch] = JModel(jcfg).init_params(jax.random.PRNGKey(0))
    return _JPARAMS[arch]


def tensor32(a) -> torch.Tensor:
    """A JAX or numpy array as a float32 torch tensor (a copy)."""
    return torch.from_numpy(np.array(a, dtype=np.float32))


def close(got, want, tol=1e-5):
    np.testing.assert_allclose(f32(got), f32(want), rtol=0, atol=tol)


def normal_np(shape, seed, scale=0.5) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def block_weights(defs_fn, jdefs_fn, arch, seed=0):
    """(jax cfg, port cfg, jax weights, the same as a namespace of
    tensors) of one block at the arch's smoke width, in float32, drawn
    from the reference's ``jdefs_fn``; the port's ``defs_fn`` must name
    the same leaves."""
    jcfg, cfg = cfgs(arch)
    jw = jinit_params(jdefs_fn(jcfg), jax.random.PRNGKey(seed), jnp.float32)
    assert sorted(jw) == sorted(defs_fn(cfg))
    return jcfg, cfg, jw, SimpleNamespace(**{k: tensor32(v)
                                             for k, v in jw.items()})


def make_prompts(cfg, lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab, size=n, dtype=np.int32)
            for n in lengths]


#: prompt lengths: even, since a MoE prompt's tokens must split into
#: min(n_groups, T) = 2 groups (ROADMAP C15); 2 gives the hybrid's
#: one-row conv buffer (C13), written into a slot a longer prompt held
LENGTHS = (12, 6, 2, 12, 2, 6)
