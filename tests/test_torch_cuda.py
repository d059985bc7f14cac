"""The CUDA kernels of the port against their plain versions, on the card.

These tests import no JAX, so they run on a machine with a card and
PyTorch alone (``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``); without a card they skip.  Ids are integers:
kernel and plain version must agree exactly."""
import numpy as np
import pytest
import torch

from repro_torch import random as tr
from repro_torch.core import sampler
from repro_torch.kernels import ref, rmat_sample as rs

pytestmark = pytest.mark.cuda

TH = [0.45, 0.22, 0.2, 0.13]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                torch.testing.assert_close(x, y, rtol=0, atol=0)


@pytest.mark.parametrize("n,m,E", [(18, 15, 1 << 20), (34, 30, 100_000),
                                   (9, 12, 777)])
def test_kernels_match_plain_versions(cuda, n, m, E):
    L = max(n, m)
    th = torch.tensor([TH] * L, dtype=torch.float32, device=cuda)
    bits = tr.bits(tr.PRNGKey(2), (L, E), cuda)
    u = ref.bits_to_uniform_ref(bits)
    want = ref.rmat_parts_ref(th, u, n, m)
    rs.reset_launches()
    _same(rs.rmat_sample_uniforms(th, u, n, m), want)
    _same(rs.rmat_sample_bits(th, bits, n, m), want)
    _same(rs.rmat_sample_prng(tr.PRNGKey(2), th, n, m, E, E), want)
    _same(rs.rmat_sample_prng(tr.PRNGKey(2), th, n, m, E - 5, E),
          ref.rmat_prng_ref(tr.PRNGKey(2), th, n, m, E - 5, E))
    assert rs.LAUNCHES == {"rmat_sample_uniforms": 1, "rmat_sample_bits": 1,
                           "rmat_sample_prng": 2}


def test_prng_kernel_per_level_thetas_and_padding(cuda):
    """K2 as the chunked main path calls it: per-level θ rows, a stride
    padded past the edge count, a chunk key from ``fold_in``."""
    n, m = 16, 13
    th = torch.from_numpy(np.random.default_rng(1).dirichlet(
        np.ones(4), size=n).astype(np.float32)).to(cuda)
    E = 300_001
    pad = sampler._pad_edges(E, sampler.choose_block(E))
    key = tr.fold_in(tr.PRNGKey(0), 5)
    _same(rs.rmat_sample_prng(key, th, n, m, E, pad),
          ref.rmat_prng_ref(key, th, n, m, E, pad))


@pytest.mark.parametrize("name", ["reference", "cuda_bits", "cuda_prng"])
def test_backends_on_card_equal_cpu(cuda, name):
    be = sampler.get_backend(name)
    th = np.tile(TH, (20, 1))
    for dt in (torch.int32, torch.int64):
        s1, d1 = be.sample(tr.PRNGKey(4), th, 20, 17, 50_000, dt, cuda)
        s2, d2 = be.sample(tr.PRNGKey(4), th, 20, 17, 50_000, dt, "cpu")
        assert torch.equal(s1.cpu(), s2) and torch.equal(d1.cpu(), d2)


def test_wrapper_rejects_mixed_devices(cuda):
    th = torch.tensor([TH] * 8, dtype=torch.float32)
    with pytest.raises(ValueError, match="thetas on cpu"):
        rs.rmat_sample_bits(th, torch.zeros((8, 64), dtype=torch.int32,
                                            device=cuda), 8, 8)
