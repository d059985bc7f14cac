"""The port's R-MAT kernels against the JAX package's Pallas kernels.

On this CPU the wrappers take their plain versions (``kernels/ref.py``);
the JAX side runs its Pallas kernels in interpret mode, as its own tests
do.  Ids are integers: they must match exactly.  The CUDA kernels are
checked against the plain versions in ``test_torch_cuda.py``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sampler as jsampler
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import random as tr
from repro_torch.core.descend import combine_ids
from repro_torch.kernels import ops, ref, rmat_sample as rs

TH = [0.45, 0.22, 0.2, 0.13]


def _thetas(L, th=TH):
    return np.tile(np.asarray(th, np.float32), (L, 1))


@pytest.mark.parametrize("n,m,E,block", [
    (8, 8, 4096, 1024),
    (12, 10, 8192, 2048),    # rectangular (bipartite)
    (6, 9, 4096, 4096),      # m > n marginal levels
])
def test_uniforms_kernel_matches_pallas(n, m, E, block):
    L = max(n, m)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(n * 100 + m),
                                    (L, E)))
    th = _thetas(L)
    s1, d1 = jops.rmat_edges(jnp.asarray(th), jnp.asarray(u), n=n, m=m,
                             block=block)
    s2, d2 = ops.rmat_edges(torch.from_numpy(th), torch.from_numpy(u),
                            n=n, m=m)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    assert int(s2.max()) < 2 ** n and int(d2.max()) < 2 ** m


@pytest.mark.parametrize("n,m,th", [
    (10, 10, [0.5, 0.2, 0.2, 0.1]),
    (11, 7, TH),
])
def test_bits_kernel_matches_pallas(n, m, th):
    L, E = max(n, m), 8192
    bits = np.array(jax.random.bits(jax.random.PRNGKey(7), (L, E),
                                    jnp.uint32))
    th = _thetas(L, th)
    s1, d1 = jops.rmat_edges_bits(jnp.asarray(th), jnp.asarray(bits), n=n,
                                  m=m, block=2048)
    s2, d2 = ops.rmat_edges_bits(torch.from_numpy(th),
                                 torch.from_numpy(bits.view(np.int32)),
                                 n=n, m=m)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))


def test_noisy_per_level_thetas():
    """Per-level θ rows are read per level, not broadcast from row 0."""
    n = m = 9
    rng = np.random.default_rng(3)
    th = rng.dirichlet(np.ones(4), size=n).astype(np.float32)
    u = rng.random((n, 4096)).astype(np.float32)
    s1, d1 = jops.rmat_edges(jnp.asarray(th), jnp.asarray(u), n=n, m=m,
                             block=1024)
    s2, d2 = ops.rmat_edges(torch.from_numpy(th), torch.from_numpy(u),
                            n=n, m=m)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))


def test_from_key_matches_pallas():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("jax is set to the non-partitionable threefry mode")
    n, m, E = 10, 8, 4096
    th = _thetas(n)
    s1, d1 = jops.rmat_edges_from_key(jax.random.PRNGKey(5), jnp.asarray(th),
                                      n=n, m=m, n_edges=E, block=1024,
                                      interpret=True)
    s2, d2 = ops.rmat_edges_from_key(tr.PRNGKey(5), torch.from_numpy(th),
                                     n=n, m=m, n_edges=E)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))


@pytest.mark.parametrize("n,m,E", [(12, 9, 3000), (34, 30, 1000)])
def test_prng_plain_version_matches_pallas_bits(n, m, E):
    """The in-register-threefry kernel's plain version gives the JAX
    ``pallas_bits`` backend's ids, narrow and wide."""
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("jax is set to the non-partitionable threefry mode")
    L = max(n, m)
    th = _thetas(L)
    dt = np.int64 if L > 31 else np.int32
    s1, d1 = jsampler.get_backend("pallas_bits").sample(
        jax.random.PRNGKey(9), th, n, m, E, id_dtype=dt)
    pad = jsampler._pad_edges(E, jsampler.choose_block(E))
    src, dst = rs.rmat_sample_prng(tr.PRNGKey(9), torch.from_numpy(th), n, m,
                                   E, pad)
    np.testing.assert_array_equal(combine_ids(src, n, dt).numpy(),
                                  np.asarray(s1))
    np.testing.assert_array_equal(combine_ids(dst, m, dt).numpy(),
                                  np.asarray(d1))


@pytest.mark.parametrize("n,m,dt", [(10, 8, np.int32), (34, 30, np.int64)])
def test_plain_rmat_ref_matches_reference(n, m, dt):
    """The plain ids-from-uniforms oracle, narrow and wide (int64 from the
    (hi, lo) words), against the JAX package's ``rmat_ref``."""
    L = max(n, m)
    rng = np.random.default_rng(n)
    th = rng.dirichlet(np.ones(4), size=L).astype(np.float32)
    u = rng.random((L, 3000)).astype(np.float32)
    s1, d1 = jref.rmat_ref(jnp.asarray(th), jnp.asarray(u), n, m,
                           id_dtype=dt)
    s2, d2 = ref.rmat_ref(torch.from_numpy(th), torch.from_numpy(u), n, m,
                          id_dtype=torch.int64 if dt is np.int64
                          else torch.int32)
    np.testing.assert_array_equal(s2.numpy(), np.asarray(s1))
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))


def test_wrappers_check_inputs():
    th = torch.from_numpy(_thetas(8))
    with pytest.raises(ValueError, match="uniforms"):
        rs.rmat_sample_uniforms(th, torch.zeros((7, 16)), 8, 8)
    with pytest.raises(ValueError, match="bits"):
        rs.rmat_sample_bits(th, torch.zeros((8, 16)), 8, 8)
    with pytest.raises(ValueError, match="thetas"):
        rs.rmat_sample_bits(th.double(),
                            torch.zeros((8, 16), dtype=torch.int32), 8, 8)
    with pytest.raises(ValueError, match="wide ids"):
        ops.rmat_edges(torch.from_numpy(_thetas(32)),
                       torch.zeros((32, 16)), n=32, m=32)


def test_cpu_path_does_not_count_launches():
    rs.reset_launches()
    ops.rmat_edges_from_key(tr.PRNGKey(1), torch.from_numpy(_thetas(8)),
                            n=8, m=8, n_edges=256)
    assert all(v == 0 for v in rs.LAUNCHES.values())
