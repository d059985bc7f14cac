"""The port's Mamba2 (SSD) blocks against the JAX package's
``models/ssm.py``, and ``layers.group_norm_heads``, on the CPU
(``test_torch_rwkv.py`` holds RWKV6's).

The same inputs, made from a seed with numpy, go through the JAX function
and its port, with the JAX package's weights for one key.  Tolerances,
each with its reason:

* group norm and the causal conv: 1e-6, a few float32 roundings;
* the chunked forms, the single-token steps, the carried states and the
  recurrent oracles, in float32: 1e-5, products and cumulative sums in
  another order (the outputs are of order 1);
* the port's chunked form against its own recurrent oracle: 1e-5;
* conv buffers: 1e-6 (slices of the raw projections, one product each)."""
import jax.numpy as jnp
import pytest
import torch

from repro.models import layers as jlayers
from repro.models import ssm as jssm
from repro_torch.models import layers, ssm

from _torch_families_common import (_one_thread,  # noqa: F401
                                    block_weights, close, normal_np,
                                    tensor32)


@pytest.fixture(scope="module")
def mamba():
    return block_weights(ssm.mamba_defs, jssm.mamba_defs, "zamba2-1.2b")


def _ssm_state(cfg, B, seed):
    d_in, H, Pd, N = ssm.ssm_dims(cfg)
    dc = cfg.ssm.d_conv
    return [normal_np(s, seed + i) for i, s in enumerate(
        ((B, H, Pd, N), (B, dc - 1, d_in), (B, dc - 1, N), (B, dc - 1, N)))]


# ---------------------------------------------------------------------------
# small pieces
# ---------------------------------------------------------------------------

def test_group_norm_heads_matches_reference():
    """Population variance, as ``jnp.var`` (torch's default would divide
    by K - 1)."""
    x = normal_np((2, 5, 64), 0, 3.0) + 1.0
    w = normal_np((64,), 1, 1.0)
    want = jlayers.group_norm_heads(jnp.asarray(x), jnp.asarray(w), 4)
    close(layers.group_norm_heads(tensor32(x), tensor32(w), 4), want, 1e-6)


def test_causal_conv_matches_reference(mamba):
    jcfg, cfg, jw, w = mamba
    x = normal_np((2, 7, w.conv_x.shape[1]), 2)
    want = jssm._causal_conv(jnp.asarray(x), jw["conv_x"])
    close(ssm._causal_conv(tensor32(x), w.conv_x), want, 1e-6)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 37, 5])
def test_mamba_block_matches_reference(mamba, S):
    """The chunked SSD scan (chunk 16: 2, 3 ragged, 1 short chunk)."""
    jcfg, cfg, jw, w = mamba
    x = normal_np((2, S, cfg.d_model), 4)
    want, _ = jssm.mamba_block(jw, jnp.asarray(x), jcfg)
    got, st = ssm.mamba_block(w, tensor32(x), cfg)
    assert st is None
    close(got, want)


@pytest.mark.parametrize("S", [32, 21, 2])
def test_mamba_prefill_state_matches_reference(mamba, S):
    """With a carried state: the output, the new float32 state and the
    conv buffers (the last d_conv - 1 raw projections; 2 tokens leave a
    one-row buffer in both packages, ROADMAP C13)."""
    jcfg, cfg, jw, w = mamba
    x = normal_np((2, S, cfg.d_model), 5)
    st = _ssm_state(cfg, 2, 6)
    want, jst = jssm.mamba_block(jw, jnp.asarray(x), jcfg,
                                 jssm.SSMState(*map(jnp.asarray, st)))
    got, new = ssm.mamba_block(w, tensor32(x), cfg,
                               ssm.SSMState(*map(tensor32, st)))
    close(got, want)
    close(new.state, jst.state)
    assert new.state.dtype == torch.float32
    for a, b in zip(new[1:], jst[1:]):
        assert tuple(a.shape) == b.shape
        close(a, b, 1e-6)
    assert new.conv_x.shape[1] == (1 if S == 2 else cfg.ssm.d_conv - 1)


def test_mamba_decode_matches_reference(mamba):
    jcfg, cfg, jw, w = mamba
    x = normal_np((3, 1, cfg.d_model), 7)
    st = _ssm_state(cfg, 3, 8)
    want, jst = jssm._mamba_decode(jw, jnp.asarray(x), jcfg,
                                   jssm.SSMState(*map(jnp.asarray, st)))
    got, new = ssm.mamba_block(w, tensor32(x), cfg, ssm.SSMState(*map(tensor32, st)))
    close(got, want)
    for a, b in zip(new, jst):
        close(a, b)


def test_mamba_oracles_match(mamba):
    """The recurrent oracle against the reference's, and the chunked form
    against the oracle (the reference's own test holds them to 2e-3)."""
    jcfg, cfg, jw, w = mamba
    x = normal_np((2, 20, cfg.d_model), 9)
    want = jssm.mamba_reference(jw, jnp.asarray(x), jcfg)
    oracle = ssm.mamba_reference(w, tensor32(x), cfg)
    close(oracle, want)
    close(ssm.mamba_block(w, tensor32(x), cfg)[0], oracle)
