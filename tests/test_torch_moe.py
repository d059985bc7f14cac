"""The port's MoE FFN against the JAX package's ``models/moe.py``, on the
CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port.  Tolerances, each with its reason:

* the router's expert ids, the dispatch buffers (token slots, dropped
  tokens) and the top-k's tie order: equal, exactly;
* the router's gates and aux loss: 1e-6, a softmax of float32 logits
  summed in another order;
* ``moe_ffn_tp`` in float32: 1e-5, the experts' products summed in
  another order."""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import moe as jmoe
from repro.models.params import init_params as jinit_params
from repro_torch import random as tr
from repro_torch.configs import get_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import moe
from repro_torch.models.params import init_params, leaves

from _torch_families_common import _one_thread  # noqa: F401

ARCHS = ["qwen3-moe-30b-a3b", "llama4-scout-17b-16e"]


def _cfgs(arch, **moe_kw):
    """The arch's smoke config in float32 (qwen3: top-2 of 4 experts,
    llama4: top-1), both packages'; ``moe_kw`` overrides its MoEConfig."""
    out = []
    for get in (jget_config, get_config):
        cfg = get(arch).smoke().replace(dtype="float32")
        if moe_kw:
            cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_kw))
        out.append(cfg)
    return out


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _ns(tree):
    return SimpleNamespace(**{k: [torch.from_numpy(np.asarray(a).copy())
                                  for a in v] if isinstance(v, list)
                              else torch.from_numpy(np.asarray(v).copy())
                              for k, v in tree.items()})


def _x(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# ---------------------------------------------------------------------------
# router and dispatch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches_reference(arch):
    jcfg, cfg = _cfgs(arch)
    x = _x((2, 16, cfg.d_model), 0)
    gate = _x((cfg.d_model, cfg.moe.n_experts), 1) * 0.3
    je, jg, jaux = jmoe._route(jnp.asarray(x), jnp.asarray(gate), jcfg)
    e, g, aux = moe._route(torch.from_numpy(x), torch.from_numpy(gate), cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=0,
                               atol=1e-6)
    assert abs(float(aux) - float(jaux)) < 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_route_breaks_ties_like_top_k(arch):
    """A zero gate gives every expert the same probability: the top-k
    takes the lowest ids first, as ``jax.lax.top_k`` does."""
    jcfg, cfg = _cfgs(arch)
    x = _x((2, 8, cfg.d_model), 2)
    gate = np.zeros((cfg.d_model, cfg.moe.n_experts), np.float32)
    je, _, _ = jmoe._route(jnp.asarray(x), jnp.asarray(gate), jcfg)
    e, g, _ = moe._route(torch.from_numpy(x), torch.from_numpy(gate), cfg)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))
    assert (e.numpy() == np.arange(cfg.moe.top_k)).all()


@pytest.mark.parametrize("capacity_factor", [2.0, 1.0, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_buffers_match_reference(arch, capacity_factor):
    """Token slots and gates equal, exactly; at a capacity factor of 0.5
    some tokens are dropped, and the same ones in both packages."""
    jcfg, cfg = _cfgs(arch, capacity_factor=capacity_factor)
    G, Tg, E, k = 2, 16, cfg.moe.n_experts, cfg.moe.top_k
    x = _x((G, Tg, cfg.d_model), 3)
    gate = _x((cfg.d_model, E), 4)
    je, jg, _ = jmoe._route(jnp.asarray(x), jnp.asarray(gate), jcfg)
    C = max(1, int(Tg * k * capacity_factor / E))
    jtok, jgate = jmoe._dispatch_buffers(je, jg, Tg, E, C)
    tok, gate_buf = moe._dispatch_buffers(
        torch.from_numpy(np.array(je)), torch.from_numpy(np.array(jg)),
        Tg, E, C)
    assert tok.dtype == torch.int32 and tuple(tok.shape) == (G, E, C)
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(gate_buf.numpy(), np.asarray(jgate))
    kept = int((tok.numpy() < Tg).sum())
    if capacity_factor == 0.5:
        assert kept < G * Tg * k                     # tokens were dropped
    else:
        assert kept <= G * Tg * k


# ---------------------------------------------------------------------------
# the FFN
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_defs_and_init_match_reference(arch, stacked):
    """Both tree forms: stacked (E, D, F) experts, or lists of E; the same
    key draws the same weights (1e-6)."""
    jcfg, cfg = _cfgs(arch)
    jw = jinit_params(jmoe.moe_defs(jcfg, stacked=stacked),
                      jax.random.PRNGKey(0), jnp.float32)
    w = init_params(moe.moe_defs(cfg, stacked=stacked), tr.PRNGKey(0),
                    "float32", "cpu")
    want, got = jax.tree.leaves(jw), leaves(w)
    assert len(got) == len(want)
    for g, v in zip(got, want):
        assert tuple(g.shape) == v.shape
        np.testing.assert_allclose(_f32(g), _f32(v), rtol=0, atol=1e-6)


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
@pytest.mark.parametrize("stacked", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_tp_matches_reference(arch, stacked, capacity_factor):
    kw = {} if capacity_factor is None else {
        "capacity_factor": capacity_factor}
    jcfg, cfg = _cfgs(arch, **kw)
    jw = jinit_params(jmoe.moe_defs(jcfg, stacked=stacked),
                      jax.random.PRNGKey(5), jnp.float32)
    x = _x((2, 16, cfg.d_model), 6)
    jout, jaux = jmoe.moe_ffn_tp(jw, jnp.asarray(x), jcfg.replace(
        scan_layers=stacked))
    out, aux = moe.moe_ffn(_ns(jw), torch.from_numpy(x), cfg)
    assert out.shape == (2, 16, cfg.d_model)
    np.testing.assert_allclose(out.numpy(), _f32(jout), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) < 1e-6


def test_moe_ffn_accumulates_in_the_model_dtype():
    """bf16 in, bf16 accumulator out; against the reference within one
    bf16 step of the output's scale (2e-2)."""
    jcfg, cfg = _cfgs("qwen3-moe-30b-a3b")
    jcfg, cfg = (c.replace(dtype="bfloat16") for c in (jcfg, cfg))
    jw = jinit_params(jmoe.moe_defs(jcfg), jax.random.PRNGKey(7),
                      jnp.bfloat16)
    x = _x((2, 16, cfg.d_model), 8)
    jout, _ = jmoe.moe_ffn_tp(jw, jnp.asarray(x, jnp.bfloat16), jcfg)
    tw = SimpleNamespace(**{k: torch.from_numpy(
        np.array(jnp.asarray(v, jnp.float32))).to(torch.bfloat16)
        for k, v in jw.items()})
    out, _ = moe.moe_ffn(tw, torch.from_numpy(x).to(torch.bfloat16), cfg)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(out), _f32(jout), rtol=0, atol=2e-2)


def test_moe_ffn_refuses_an_uneven_group_split():
    """T tokens must split into min(n_groups, T) groups, as the
    reference asserts."""
    cfg = get_config("qwen3-moe-30b-a3b").smoke().replace(
        moe=MoEConfig(n_experts=4, top_k=2, capacity_factor=2.0, n_groups=4))
    w = init_params(moe.moe_defs(cfg), tr.PRNGKey(0), "float32", "cpu")
    with pytest.raises(ValueError, match="groups"):
        moe.moe_ffn(SimpleNamespace(**w), torch.zeros(1, 6, cfg.d_model),
                    cfg)
