"""The port's RWKV6 (WKV6) blocks against the JAX package's
``models/rwkv.py``, on the CPU.

The same inputs, made from a seed with numpy, go through the JAX function
and its port, with the JAX package's weights for one key.  Tolerances,
each with its reason:

* the decay and its clamps: 1e-6, a few float32 roundings;
* the chunked forms, the single-token steps, the carried states and the
  recurrent oracles, in float32: 1e-5, products and cumulative sums in
  another order (the outputs are of order 1);
* the port's chunked form against its own recurrent oracle: 1e-5;
* token shifts: equal, exactly (slices of the input)."""
from types import SimpleNamespace

import jax.numpy as jnp
import pytest
import torch

from repro.models import rwkv as jrwkv
from repro_torch.models import rwkv

from _torch_families_common import (_one_thread,  # noqa: F401
                                    block_weights, close, normal_np,
                                    tensor32)


@pytest.fixture(scope="module")
def wkv():
    return block_weights(rwkv.rwkv_defs, jrwkv.rwkv_defs, "rwkv6-7b")


def _rwkv_state(cfg, B, seed):
    H, K = rwkv.rwkv_dims(cfg)
    return [normal_np(s, seed + i) for i, s in enumerate(
        ((B, H, K, K), (B, cfg.d_model), (B, cfg.d_model)))]


# ---------------------------------------------------------------------------
# the decay
# ---------------------------------------------------------------------------

def test_log_decay_matches_reference(wkv):
    """The data-dependent decay and its clamps to [-2.2, -1e-6]; a large
    input drives the LoRA into both clamps."""
    jcfg, cfg, jw, w = wkv
    for scale in (0.5, 400.0):
        x = normal_np((2, 9, cfg.d_model), 3, scale)
        want = jrwkv._log_decay(jw, jnp.asarray(x))
        got = rwkv._log_decay(w, tensor32(x))
        close(got, want, 1e-6)
        assert float(got.max()) <= -1e-6
        assert float(got.min()) >= -rwkv.DECAY_CLAMP


# ---------------------------------------------------------------------------
# RWKV6
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S", [32, 37, 5])
def test_time_mix_matches_reference(wkv, S):
    """The chunked GLA form (chunk 16), e^±cum kept in the reference's
    order."""
    jcfg, cfg, jw, w = wkv
    x = normal_np((2, S, cfg.d_model), 10)
    want, _ = jrwkv.time_mix(jw, jnp.asarray(x), jcfg)
    got, st = rwkv.time_mix(w, tensor32(x), cfg)
    assert st is None
    close(got, want)


def test_time_mix_at_the_decay_clamp(wkv):
    """Decays pinned at the clamp (w0 = 2: every step's log-decay is
    -2.2): |cum| reaches 16 * 2.2 = 35.2 in a chunk, and e^±cum stays in
    float32 range and matches the reference."""
    jcfg, cfg, jw, w = wkv
    jw2 = dict(jw, w0=jnp.full_like(jw["w0"], 2.0))
    w2 = SimpleNamespace(**{**vars(w), "w0": tensor32(jw2["w0"])})
    x = normal_np((1, 48, cfg.d_model), 11)
    want, _ = jrwkv.time_mix(jw2, jnp.asarray(x), jcfg)
    got, _ = rwkv.time_mix(w2, tensor32(x), cfg)
    assert bool(torch.isfinite(got).all())
    close(got, want)


@pytest.mark.parametrize("S", [32, 19])
def test_time_mix_prefill_state_matches_reference(wkv, S):
    jcfg, cfg, jw, w = wkv
    x = normal_np((2, S, cfg.d_model), 12)
    st = _rwkv_state(cfg, 2, 13)
    want, jst = jrwkv.time_mix(jw, jnp.asarray(x), jcfg,
                               jrwkv.RWKVState(*map(jnp.asarray, st)))
    got, new = rwkv.time_mix(w, tensor32(x), cfg, rwkv.RWKVState(*map(tensor32, st)))
    close(got, want)
    for a, b in zip(new, jst):
        assert tuple(a.shape) == b.shape
        close(a, b)


def test_time_mix_decode_matches_reference(wkv):
    jcfg, cfg, jw, w = wkv
    x = normal_np((3, 1, cfg.d_model), 14)
    st = _rwkv_state(cfg, 3, 15)
    want, jst = jrwkv._time_mix_decode(jw, jnp.asarray(x), jcfg,
                                       jrwkv.RWKVState(*map(jnp.asarray,
                                                            st)))
    got, new = rwkv.time_mix(w, tensor32(x), cfg, rwkv.RWKVState(*map(tensor32, st)))
    close(got, want)
    for a, b in zip(new, jst):
        close(a, b)


@pytest.mark.parametrize("with_state", [False, True])
def test_channel_mix_matches_reference(wkv, with_state):
    jcfg, cfg, jw, w = wkv
    x = normal_np((2, 9, cfg.d_model), 16)
    st = _rwkv_state(cfg, 2, 17)
    jst = jrwkv.RWKVState(*map(jnp.asarray, st)) if with_state else None
    tst = rwkv.RWKVState(*map(tensor32, st)) if with_state else None
    want, jnew = jrwkv.channel_mix(jw, jnp.asarray(x), jst)
    got, new = rwkv.channel_mix(w, tensor32(x), tst)
    close(got, want)
    if with_state:
        close(new.shift_cm, jnew.shift_cm, 0.0)


def test_wkv_oracles_match(wkv):
    jcfg, cfg, jw, w = wkv
    x = normal_np((2, 20, cfg.d_model), 18)
    want = jrwkv.wkv_reference(jw, jnp.asarray(x), jcfg)
    oracle = rwkv.wkv_reference(w, tensor32(x), cfg)
    close(oracle, want)
    close(rwkv.time_mix(w, tensor32(x), cfg)[0], oracle)
