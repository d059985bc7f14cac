"""The port's threefry random numbers against ``jax.random``.

Integer streams (keys, bits, uniforms, randint) must match exactly; the
float transforms ``normal`` and ``gumbel`` within 1e-6 absolute, because
torch's ``log``/``log1p`` may round a float32 result one ulp away from
XLA's (values reach ~16 for gumbel, where one ulp is ~1e-6)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch import random as tr

SEEDS = [0, 7, 123456789]


def _require_partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31, 2 ** 32 - 1, 2 ** 32 + 5,
                                  2 ** 62 + 12345, 2 ** 63 - 1])
def test_prngkey_matches_jax(seed):
    """jax without x64 keeps only a seed's low 32 bits."""
    np.testing.assert_array_equal(tr.PRNGKey(seed).numpy(),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_and_fold_in_match_jax(seed):
    _require_partitionable()
    k, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    np.testing.assert_array_equal(tr.split(tk, 7).numpy(),
                                  np.asarray(jax.random.split(k, 7)))
    for d in (0, 5, 0x5eed, 2 ** 31 + 3):
        np.testing.assert_array_equal(tr.fold_in(tk, d).numpy(),
                                      np.asarray(jax.random.fold_in(k, d)))


@pytest.mark.parametrize("seed,shape", [(0, (5,)), (7, (3, 1001)),
                                        (123456789, (18, 4096))])
def test_bits_and_uniform_match_jax(seed, shape):
    _require_partitionable()
    k, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    want = np.asarray(jax.random.bits(k, shape, jnp.uint32))
    np.testing.assert_array_equal(tr.bits(tk, shape).numpy().view(np.uint32),
                                  want)
    np.testing.assert_array_equal(tr.uniform(tk, shape).numpy(),
                                  np.asarray(jax.random.uniform(k, shape)))


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_gumbel_close_to_jax(seed):
    _require_partitionable()
    k, tk = jax.random.PRNGKey(seed), tr.PRNGKey(seed)
    shape = (64, 1024)
    np.testing.assert_allclose(tr.normal(tk, shape).numpy(),
                               np.asarray(jax.random.normal(k, shape)),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tr.gumbel(tk, shape).numpy(),
                               np.asarray(jax.random.gumbel(k, shape)),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("lo,hi", [(0, 2 ** 31 - 1), (3, 17), (-5, 1000)])
def test_randint_matches_jax(lo, hi):
    _require_partitionable()
    k, tk = jax.random.PRNGKey(11), tr.PRNGKey(11)
    np.testing.assert_array_equal(
        tr.randint(tk, (4096,), lo, hi).numpy(),
        np.asarray(jax.random.randint(k, (4096,), lo, hi)))


def test_bits_chunking_is_invisible(monkeypatch):
    """Drawing in several threefry passes gives the same words."""
    tk = tr.PRNGKey(3)
    whole = tr.bits(tk, (6, 1000))
    monkeypatch.setattr(tr, "_CHUNK", 999)
    torch.testing.assert_close(tr.bits(tk, (6, 1000)), whole, rtol=0, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
def test_normal_range_is_a_slice_of_normal(seed):
    """A leaf drawn in pieces (``init_params``) equals the whole draw,
    bit for bit, and pieces cut across rows of any shape."""
    key = tr.PRNGKey(seed)
    whole = tr.normal(key, (6, 7, 11))
    flat = whole.reshape(-1)
    for lo, hi in ((0, 462), (0, 5), (5, 77), (300, 462)):
        assert torch.equal(tr.normal_range(key, lo, hi), flat[lo:hi])


def test_init_params_pieces_are_invisible(monkeypatch):
    """A normal leaf drawn in pieces of 7 elements equals one drawn
    whole, in float32 and cast to bfloat16."""
    from repro_torch.models import params
    defs = {"a": params.ParamDef((5, 9, 4), ("embed", "heads", None)),
            "b": params.ParamDef((3, 33), ("embed", "mlp"), scale=0.5)}
    for dtype in ("float32", "bfloat16"):
        whole = params.init_params(defs, tr.PRNGKey(4), dtype, "cpu")
        monkeypatch.setattr(params, "INIT_CPU_PIECE", 7)
        cut = params.init_params(defs, tr.PRNGKey(4), dtype, "cpu")
        monkeypatch.undo()
        for k in defs:
            assert torch.equal(cut[k], whole[k]), (k, dtype)
