"""The CUDA kernels of the port against their plain versions, on the card.

These tests import no JAX, so they run on a machine with a card and
PyTorch alone (``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``); without a card they skip.  Ids are integers:
the R-MAT kernels and their plain versions must agree exactly, and so
must the probes S1–S3 (S4 within 1e-6).  Flash attention is held to 2e-5
in float32 (online vs full softmax differ in summation order; TF32 is off
for the plain version's products) and 2e-2 in bfloat16 (one bf16 rounding
of outputs of magnitude ~1, and of p on the tensor-core route)."""
import numpy as np
import pytest
import torch

from repro_torch import random as tr
from repro_torch.configs import get_config
from repro_torch.core import sampler
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref, rmat_sample as rs, spike
from repro_torch.models import Model

pytestmark = pytest.mark.cuda

TH = [0.45, 0.22, 0.2, 0.13]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
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


ATTN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(Hkv, group, S, T, d, dtype, device, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to(device, dtype)
            for shape in ((Hkv * group, S, d), (Hkv, T, d), (Hkv, T, d))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain_version(cuda, dtype, d, causal):
    q, k, v = _qkv(2, 4, 256, 256, d, dtype, cuda, seed=d)
    fa.reset_launches()
    got = ops.attention(q, k, v, causal=causal, group=4)
    assert fa.LAUNCHES["flash_attention"] == 1
    want = ref.attention_ref(q, k, v, causal=causal, group=4)
    assert got.dtype == dtype
    err = (got.float() - want.float()).abs().max().item()
    assert err < ATTN_TOL[dtype], err


@pytest.mark.parametrize("group", [1, 4, 8, 16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
def test_tensor_core_route_matches_plain_version(cuda, d, causal, group):
    """bf16 with d 64 or 128 takes the wgmma kernel, one launch."""
    q, k, v = _qkv(2, group, 384, 384, d, torch.bfloat16, cuda, seed=group)
    fa.reset_launches()
    got = ops.attention(q, k, v, causal=causal, group=group)
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 1,
                           "flash_attention_fma": 0}
    want = ref.attention_ref(q, k, v, causal=causal, group=group)
    err = (got.float() - want.float()).abs().max().item()
    assert err < ATTN_TOL[torch.bfloat16], err


@pytest.mark.parametrize("S,T,d,causal", [(1000, 1000, 64, True),
                                          (96, 160, 128, True),
                                          (200, 72, 64, False),
                                          (136, 136, 128, False)])
def test_tensor_core_route_ragged(cuda, S, T, d, causal):
    """Rows past S are not stored, keys past T are masked."""
    q, k, v = _qkv(2, 4, S, T, d, torch.bfloat16, cuda, seed=S + T)
    fa.reset_launches()
    got = ops.attention(q, k, v, causal=causal, group=4, blk_q=8, blk_k=8)
    assert fa.LAUNCHES["flash_attention_wgmma"] == 1
    want = ref.attention_ref(q, k, v, causal=causal, group=4)
    err = (got.float() - want.float()).abs().max().item()
    assert err < ATTN_TOL[torch.bfloat16], err


@pytest.mark.parametrize("dtype,d", [(torch.float32, 64),
                                     (torch.float32, 128),
                                     (torch.bfloat16, 32),
                                     (torch.bfloat16, 16)])
def test_fma_route_takes_float32_and_small_head_dims(cuda, dtype, d):
    q, k, v = _qkv(2, 2, 128, 128, d, dtype, cuda)
    fa.reset_launches()
    ops.attention(q, k, v, group=2)
    assert fa.LAUNCHES == {"flash_attention": 1, "flash_attention_wgmma": 0,
                           "flash_attention_fma": 1}


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_tiles(cuda, causal):
    """S and T that are no multiple of the kernel's 64-row tiles, S != T."""
    q, k, v = _qkv(3, 2, 96, 160, 64, torch.float32, cuda, seed=1)
    got = ops.attention(q, k, v, causal=causal, group=2, blk_q=32, blk_k=32)
    want = ref.attention_ref(q, k, v, causal=causal, group=2)
    assert (got - want).abs().max().item() < ATTN_TOL[torch.float32]


def test_flash_attention_rejects_mixed_devices(cuda):
    q, k, v = _qkv(2, 1, 128, 128, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="one device"):
        ops.attention(q, k.cpu(), v)


def test_flash_attention_rejects_unsupported_head_dim(cuda):
    q, k, v = _qkv(2, 1, 128, 128, 48, torch.float32, cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.attention(q, k, v)


@pytest.mark.parametrize("B", [1, 2])
def test_flash_forward_matches_einsum_on_card(cuda, B):
    """The scoring forward through the kernel, one launch per layer, equal
    to the einsum path in float32 (1e-4: products summed in another
    order)."""
    cfg = get_config("tinyllama-1.1b").smoke().replace(
        dtype="float32", n_heads=8, n_kv_heads=2, head_dim=16)
    model = Model(cfg.replace(attn_impl="flash"), cuda)
    params = model.init_params(tr.PRNGKey(0))
    toks = tr.randint(tr.PRNGKey(1), (B, 256), 0, cfg.vocab, cuda)
    fa.reset_launches()
    flash = model.forward(params, {"tokens": toks}).logits
    assert fa.LAUNCHES["flash_attention"] == cfg.n_layers
    einsum = Model(cfg, cuda).forward(params, {"tokens": toks}).logits
    assert (flash - einsum).abs().max().item() < 1e-4


def test_probes_match_plain_versions(cuda):
    """S1–S4 at the shapes of ``scripts/spike_pallas.py``, one launch each."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn((8, 128), generator=gen).to(cuda)
    y = torch.randn((8, 128), generator=gen).to(cuda)
    big = torch.randn((1024, 256), generator=gen).to(cuda)
    seed = torch.tensor([42], dtype=torch.int32, device=cuda)
    spike.reset_launches()
    assert torch.equal(spike.add(x, y), ref.add_ref(x, y))
    assert torch.equal(spike.double_blocks(big), ref.double_ref(big))
    assert torch.equal(spike.prng_bits(seed, (8, 128)),
                       ref.prng_bits_ref(seed, (8, 128)))
    err = (spike.column_sum(x) - ref.column_sum_ref(x)).abs().max().item()
    assert err <= 1e-6
    assert spike.LAUNCHES == {"add": 1, "double_blocks": 1, "prng_bits": 1,
                              "column_sum": 1}


def test_prng_probe_is_the_random_stream(cuda):
    """S3's words are ``random.bits`` at any length, past one grid pass."""
    seed = torch.tensor([-5], dtype=torch.int32, device=cuda)
    got = spike.prng_bits(seed, (3, 1 << 20))
    assert torch.equal(got.cpu(), tr.bits(tr.PRNGKey(-5), (3, 1 << 20)))
