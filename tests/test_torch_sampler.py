"""The port's edge-sampler backends against the JAX package's streams.

Each port backend names the JAX backend whose stream it reproduces
(``reference`` → ``xla``; ``cuda_bits`` and ``cuda_prng`` →
``pallas_bits``); on this CPU the CUDA backends run their kernels' plain
versions.  Ids must match exactly, narrow (int32) and wide (n=34, int64
from the (hi, lo) words)."""
import functools

import jax
import numpy as np
import pytest
import torch

from repro.core import rmat as jrmat
from repro.core import sampler as jsampler
from repro.core.structure import KroneckerFit as JFit
from repro_torch import random as tr
from repro_torch.core import rmat, sampler
from repro_torch.core.structure import KroneckerFit

FIT = dict(a=0.45, b=0.22, c=0.2, d=0.13)


@pytest.fixture(autouse=True)
def _partitionable():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("the port reproduces jax's partitionable threefry mode; "
                    "jax is set to the other mode")


def _thetas(L):
    return np.tile([0.45, 0.22, 0.2, 0.13], (L, 1))


@functools.lru_cache(maxsize=None)
def _jax_stream(stream, n, m, E):
    """The JAX backend's ids, once per stream: two port backends share
    ``pallas_bits``."""
    dt = np.int64 if max(n, m) > 31 else np.int32
    s, d = jsampler.get_backend(stream).sample(
        jax.random.PRNGKey(n + E), _thetas(max(n, m)), n, m, E, id_dtype=dt)
    return np.asarray(s), np.asarray(d)


@functools.lru_cache(maxsize=None)
def _jax_chunked(jbackend, n, m, noise):
    jfit = JFit(**FIT, n=n, m=m, E=6000, noise=noise)
    s, d = jrmat.sample_graph_chunked(jax.random.PRNGKey(4), jfit, k_pref=1,
                                      rng=np.random.default_rng(8),
                                      backend=jbackend)
    return np.asarray(s), np.asarray(d)


@pytest.mark.parametrize("name", ["reference", "cuda_bits", "cuda_prng"])
@pytest.mark.parametrize("n,m,E", [(10, 10, 5000), (12, 7, 300),
                                   (34, 33, 2000)])
def test_backend_reproduces_its_jax_stream(name, n, m, E):
    be = sampler.get_backend(name)
    dt = torch.int64 if max(n, m) > 31 else torch.int32
    s1, d1 = _jax_stream(be.stream, n, m, E)
    s2, d2 = be.sample(tr.PRNGKey(n + E), _thetas(max(n, m)), n, m, E,
                       id_dtype=dt, device="cpu")
    assert s2.dtype == dt and s2.shape == (E,)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))


def test_registry_and_auto_selection():
    assert set(sampler.registered_backends()) == {"reference", "cuda_bits",
                                                  "cuda_prng"}
    assert sampler.resolve_backend(None, 10 ** 6, "cpu").name == "reference"
    assert sampler.resolve_backend("auto", 10 ** 6, "cuda").name == \
        "cuda_prng"
    assert sampler.resolve_backend("auto", sampler.MIN_BLOCK - 1,
                                   "cuda").name == "reference"
    assert sampler.resolve_backend("cuda_bits").name == "cuda_bits"
    with pytest.raises(KeyError, match="unknown"):
        sampler.get_backend("pallas_prng")
    for be in map(sampler.get_backend, sampler.registered_backends()):
        assert be.stream in jsampler.registered_backends()


@pytest.mark.parametrize("E", [1, 255, 256, 5000, 70_000])
def test_choose_block_and_padding_match(E):
    assert sampler.choose_block(E) == jsampler.choose_block(E)
    b = sampler.choose_block(E)
    assert sampler._pad_edges(E, b) == jsampler._pad_edges(E, b)


@pytest.mark.parametrize("backend,jbackend", [(None, None),
                                              ("cuda_bits", "pallas_bits"),
                                              ("cuda_prng", "pallas_bits")])
@pytest.mark.parametrize("n,m,noise", [(12, 12, 0.03), (13, 9, 0.05)])
def test_sample_graph_chunked_matches(backend, jbackend, n, m, noise):
    """Noisy θ from a seeded rng, chunk plan, per-chunk fold_in keys and
    prefixes: the chunked graph equals the reference's."""
    fit = KroneckerFit(**FIT, n=n, m=m, E=6000, noise=noise)
    s1, d1 = _jax_chunked(jbackend, n, m, noise)
    s2, d2 = rmat.sample_graph_chunked(tr.PRNGKey(4), fit, k_pref=1,
                                       rng=np.random.default_rng(8),
                                       backend=backend, device="cpu")
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))


def test_theta_noise_from_key_matches():
    """Without an rng the θ-noise Generator is seeded from the key
    (``randint`` of a ``fold_in``), as in the reference."""
    jfit = JFit(**FIT, n=10, m=10, E=100, noise=0.04)
    fit = KroneckerFit(**FIT, n=10, m=10, E=100, noise=0.04)
    np.testing.assert_array_equal(
        rmat.derive_thetas(fit, key=tr.PRNGKey(21)),
        jrmat.derive_thetas(jfit, key=jax.random.PRNGKey(21)))


def test_chunk_plan_matches():
    jfit = JFit(**FIT, n=14, m=11, E=123_457)
    fit = KroneckerFit(**FIT, n=14, m=11, E=123_457)
    assert rmat.chunk_plan(fit, 3) == [tuple(c) for c in
                                       jrmat.chunk_plan(jfit, 3)]


def test_wide_chunked_ids_n34():
    fit = KroneckerFit(**FIT, n=34, m=34, E=3000)
    s, d = rmat.sample_graph_chunked(tr.PRNGKey(0), fit, k_pref=1,
                                     dtype=torch.int64, device="cpu")
    js, jd = jrmat.sample_graph_chunked(jax.random.PRNGKey(0),
                                        JFit(**FIT, n=34, m=34, E=3000),
                                        k_pref=1, dtype=np.int64)
    np.testing.assert_array_equal(s.numpy(), js)
    np.testing.assert_array_equal(d.numpy(), jd)
    assert int(s.max()) < 2 ** 34


def test_overflow_guard_n34_int32():
    fit = KroneckerFit(**FIT, n=34, m=34, E=3000)
    ck = rmat.chunk_plan(fit, 2)[0]
    with pytest.raises(ValueError, match="34 id bits.*int32"):
        rmat.sample_chunk(tr.PRNGKey(0), fit, ck, 2, device="cpu")


@pytest.mark.parametrize("L,E", [(12, 256), (34, 1000)])
def test_cuda_bits_draw_is_the_pallas_bits_draw(L, E):
    """``draw_bits`` names its device (no CPU default) and draws the JAX
    ``pallas_bits`` backend's words there."""
    key = jax.random.PRNGKey(L * E)
    want = np.asarray(jsampler.get_backend("pallas_bits").draw_bits(key, L,
                                                                     E))
    draw = sampler.get_backend("cuda_bits").draw_bits
    got = draw(tr.PRNGKey(L * E), L, E, "cpu")
    assert got.device.type == "cpu" and tuple(got.shape) == (L, E)
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))
    with pytest.raises(TypeError):
        draw(tr.PRNGKey(L * E), L, E)
