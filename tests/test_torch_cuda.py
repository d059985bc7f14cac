"""The CUDA kernels of the port against their plain versions, on the card.

These tests import no JAX, so they run on a machine with a card and
PyTorch alone (``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_cuda.py``); without a card they skip.  Ids are integers:
the R-MAT kernels and their plain versions must agree exactly, and so
must the probes S1–S4 (S4 also within 1e-6 at the spike's shape, the
Pallas check's tolerance).  Flash attention is held to 2e-5 in float32
(online vs full softmax differ in summation order; TF32 is off for the
plain version's products) and 2e-2 in bfloat16 (one bf16 rounding of
outputs of magnitude ~1); on early causal rows with V scaled by 8 the
tensor-core route is held to one bf16 step where |out| ≥ 4.  A fit on
the card gives the CPU's bit-pair counts, structure and VGMs exactly;
its GAN weights after 10 steps within 1e-5 of the CPU's (cuBLAS sums in
another order) and its holdout qualities within 0.02.  The streaming
fit's accumulators on the card equal the CPU's exactly (the reservoir's
int64 hash is numpy's uint64 ``_mix64``), and so does its fit JSON.  The
fidelity scores and graph statistics on the card equal the CPU's
(integers exactly, floats within 1e-9 relative), and a GCN trained on the
card follows the CPU's losses within 1e-4.  The baseline generators (ER
and SBM ids, KDE and Random rows, ``sample_erdos_renyi``) give the CPU's
bytes exactly: the same numpy draws, integer work and IEEE float64
arithmetic on the card.  The benchmarks' ``timeit`` of a K2 draw covers
the draw's CUDA-event time, and Fig. 8 times its three backends on the
card, each at most its H100 bound."""
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


#: V's scale in the early-row checks: early causal rows then reach |out|
#: of 4–32, where one bf16 step is 2^-5–2^-3
V_SCALE = 8.0


def _early_row_excess(got, want, v_scale=V_SCALE):
    """max |got − want| over its limit: one bf16 step at |want|,
    ``2**(floor(log2|want|) − 7)``, where |want| ≥ 4; elsewhere the bf16
    tolerance times the V scale (attention is linear in V).  At most 1
    passes."""
    got, want = got.float(), want.float()
    a = want.abs()
    step = torch.exp2(torch.floor(torch.log2(a.clamp_min(4.0))) - 7)
    limit = torch.where(a >= 4, step, torch.full_like(
        a, ATTN_TOL[torch.bfloat16] * v_scale))
    return ((got - want).abs() / limit).max().item()


@pytest.mark.parametrize("d", fa.WGMMA_HEAD_DIMS)
@pytest.mark.parametrize("S", [256, 2048])
def test_tensor_core_route_holds_early_causal_rows(cuda, S, d):
    """V scaled by 8: the early causal rows (few keys, each p weighing
    much) reach |out| ≥ 4, where the route must stay within one bf16 step
    of the plain version on float32 copies of the same bf16 inputs.  SDPA's
    reading on the same inputs is printed beside it, not held."""
    q, k, v = _qkv(4, 4, S, S, d, torch.bfloat16, cuda, seed=S + d)
    v = v * V_SCALE
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=True,
                             group=4)
    assert (want[:, :16].abs() >= 4).any()
    fa.reset_launches()
    got = ops.attention(q, k, v, causal=True, group=4)
    assert fa.LAUNCHES["flash_attention_wgmma"] == 1
    sdpa = torch.nn.functional.scaled_dot_product_attention(
        q[None], k[None], v[None], is_causal=True, enable_gqa=True)[0]
    excess = _early_row_excess(got, want)
    print(f"S={S} d={d}: kernel {excess:.3f}, sdpa "
          f"{_early_row_excess(sdpa, want):.3f} of the limit")
    assert excess <= 1.0, excess


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


@pytest.mark.parametrize("n", [1, 3, 1023, 1024, (1 << 24) + 3])
def test_elementwise_probes_bit_equal(cuda, n):
    """S1 and S2 through their torch ops: the n % 4 tail, one CTA, and
    past the grid cap (a grid-stride loop)."""
    gen = torch.Generator().manual_seed(n)
    x = torch.randn(n, generator=gen).to(cuda)
    y = torch.randn(n, generator=gen).to(cuda)
    spike.reset_launches()
    assert torch.equal(spike.add(x, y), ref.add_ref(x, y))
    col = x.view(n, 1)
    assert torch.equal(spike.double_blocks(col, block_rows=1),
                       ref.double_ref(col))
    assert spike.LAUNCHES["add"] == 1
    assert spike.LAUNCHES["double_blocks"] == 1


@pytest.mark.parametrize("rows,cols", [(1024, 256), (128, 3), (256, 1 << 12)])
def test_double_blocks_shapes(cuda, rows, cols):
    x = torch.randn((rows, cols), generator=torch.Generator().manual_seed(
        cols)).to(cuda)
    got = spike.double_blocks(x)
    assert got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, ref.double_ref(x))


def test_elementwise_probes_misaligned_view(cuda):
    """A contiguous view at an odd offset takes the scalar path."""
    buf = torch.randn(1026, generator=torch.Generator().manual_seed(5)).to(
        cuda)
    x = buf[1:1025]
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    y = torch.randn(1024, generator=torch.Generator().manual_seed(6)).to(
        cuda)
    assert torch.equal(spike.add(x, y), ref.add_ref(x, y))
    assert torch.equal(spike.add(y, x), ref.add_ref(y, x))
    x2 = x.view(8, 128)
    assert torch.equal(spike.double_blocks(x2, block_rows=8),
                       ref.double_ref(x2))


def test_elementwise_probes_run_on_the_current_stream(cuda):
    """Under ``torch.cuda.stream(s)`` the kernels of S1–S4 queue on ``s``:
    behind a sleep and copies on ``s`` they read the copied values (x and
    S3's seed), and an event recorded on ``s`` after the calls is still
    pending while the sleep runs."""
    gen = torch.Generator().manual_seed(9)
    new = torch.randn((1024, 256), generator=gen).to(cuda)
    y = torch.randn((1024, 256), generator=gen).to(cuda)
    x = torch.zeros_like(new)
    seed = torch.zeros(1, dtype=torch.int32, device=cuda)
    new_seed = torch.tensor([123], dtype=torch.int32, device=cuda)
    spike.add(x, y), spike.double_blocks(x)   # the op library loaded
    spike.column_sum(x), spike.prng_bits(seed, (8,))
    torch.cuda.synchronize()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        torch.cuda._sleep(500_000_000)          # ~0.25 s at 2 GHz
        x.copy_(new)
        seed.copy_(new_seed)
        added = spike.add(x, y)
        doubled = spike.double_blocks(x)
        summed = spike.column_sum(x)
        bits = spike.prng_bits(seed, (8, 128))
        done = torch.cuda.Event()
        done.record(s)
    assert not done.query()
    done.synchronize()
    assert torch.equal(added, new + y) and torch.equal(doubled, 2 * new)
    assert torch.equal(summed, ref.column_sum_ref(new))
    assert torch.equal(bits, ref.prng_bits_ref(new_seed, (8, 128)))
    s.synchronize()
    torch.cuda.synchronize()


@pytest.mark.parametrize("call,match", [
    (lambda d: spike.add(torch.zeros(128, 8, device=d).t(),
                         torch.zeros(8, 128, device=d)), "contiguous"),
    (lambda d: spike.add(torch.zeros(8, 128, device=d),
                         torch.zeros(8, 128, dtype=torch.float64, device=d)),
     "float32"),
    (lambda d: spike.add(torch.zeros(8, 128, device=d),
                         torch.zeros(8, 128)), "one device"),
    (lambda d: spike.add(torch.zeros(8, 128, device=d),
                         torch.zeros(8, 64, device=d)), "one shape"),
    (lambda d: spike.double_blocks(torch.zeros(256, 128, device=d).t()),
     "contiguous"),
    (lambda d: spike.double_blocks(torch.zeros(128, 8, dtype=torch.float16,
                                               device=d)), "float32"),
    (lambda d: spike.double_blocks(torch.zeros(200, 8, device=d)),
     "multiple"),
])
def test_elementwise_probes_refuse_what_the_cpu_path_refuses(cuda, call,
                                                             match):
    spike.reset_launches()
    with pytest.raises(ValueError, match=match):
        call(cuda)
    assert spike.LAUNCHES["add"] == spike.LAUNCHES["double_blocks"] == 0


@pytest.mark.parametrize("op", ["add", "double_blocks"])
def test_elementwise_probes_output_is_the_streams_own_tensor(cuda, op):
    """The ops' output: float32 of x's sizes on x's device, contiguous,
    its own storage, and a block of a caching-allocator segment of the
    stream current at the call."""
    x = torch.randn((256, 64), generator=torch.Generator().manual_seed(3)).to(
        cuda)
    s = torch.cuda.Stream()
    s.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(s):
        out = spike.add(x, x) if op == "add" else spike.double_blocks(x)
    s.synchronize()
    assert out.dtype == torch.float32 and out.device == x.device
    assert out.shape == x.shape and out.stride() == (64, 1)
    assert out.storage_offset() == 0 and out.data_ptr() != x.data_ptr()
    assert torch.equal(out, 2 * x)
    ptr = out.data_ptr()
    segments = [g for g in torch.cuda.memory_snapshot()
                if g["address"] <= ptr < g["address"] + g["total_size"]]
    assert len(segments) == 1 and segments[0]["stream"] == s.cuda_stream


def test_elementwise_probes_refuse_past_32_bit_indices(cuda):
    """More than 2^30 elements would overflow the kernel's int indices:
    the ops refuse them before any launch."""
    x = torch.empty((128, (1 << 23) + 1), device=cuda)   # 2^30 + 128
    spike.reset_launches()
    with pytest.raises(ValueError, match=r"at most 2\^30"):
        spike.double_blocks(x)
    flat = x.view(-1)
    with pytest.raises(ValueError, match=r"at most 2\^30"):
        spike.add(flat, flat)
    assert spike.LAUNCHES["add"] == spike.LAUNCHES["double_blocks"] == 0
    del x, flat
    torch.cuda.empty_cache()


@pytest.mark.parametrize("rows,cols", [(8, 128), (8, 1), (8, 3), (8, 129),
                                       (0, 128), (13, 4), (64, 1 << 20)])
def test_column_sum_probe_bit_equal(cuda, rows, cols):
    """S4 through its torch op, one launch: the float4 pass, the scalar
    pass (C % 4 != 0), the row loop's tail past its unrolled blocks
    (R = 13), no rows (zeros) and a bytes-bound shape."""
    x = torch.randn((rows, cols), generator=torch.Generator().manual_seed(
        rows + cols)).to(cuda)
    spike.reset_launches()
    got = spike.column_sum(x)
    assert spike.LAUNCHES["column_sum"] == 1
    assert got.shape == (1, cols) and got.dtype == torch.float32
    assert torch.equal(got, ref.column_sum_ref(x))


def test_column_sum_probe_misaligned_view(cuda):
    """A contiguous view at an odd offset takes the scalar pass."""
    buf = torch.randn(16 * 128 + 1, generator=torch.Generator().manual_seed(
        7)).to(cuda)
    x = buf[1:].view(16, 128)
    assert x.is_contiguous() and x.data_ptr() % 16 == 4
    assert torch.equal(spike.column_sum(x), ref.column_sum_ref(x))


@pytest.mark.parametrize("n", [1, 3, 1023, 1024, (1 << 24) + 3])
def test_prng_probe_bit_equal(cuda, n):
    """S3 through its torch op, one launch: the n % 4 tail, one CTA, and
    past the grid cap (a grid-stride loop)."""
    seed = torch.tensor([n], dtype=torch.int32, device=cuda)
    spike.reset_launches()
    got = spike.prng_bits(seed, (n,))
    assert spike.LAUNCHES["prng_bits"] == 1
    assert got.dtype == torch.int32 and got.shape == (n,)
    assert torch.equal(got, ref.prng_bits_ref(seed, (n,)))


@pytest.mark.parametrize("call,match", [
    (lambda d: spike.column_sum(torch.zeros(128, 8, device=d).t()),
     "contiguous"),
    (lambda d: spike.column_sum(torch.zeros(8, 128, dtype=torch.float64,
                                            device=d)), "float32"),
    (lambda d: spike.column_sum(torch.zeros(128, device=d)), "2-d"),
    (lambda d: spike.prng_bits(torch.tensor([1], device=d), (8, 128)),
     "int32"),
    (lambda d: spike.prng_bits(torch.tensor([1, 2], dtype=torch.int32,
                                            device=d), (8, 128)),
     "one int32"),
    (lambda d: spike.prng_bits(torch.ones((1, 1), dtype=torch.int32,
                                          device=d), (8,)), "1-d"),
    (lambda d: spike.prng_bits(torch.ones(1, dtype=torch.int32, device=d),
                               (8, -1)), "negative"),
])
def test_sum_and_prng_probes_refuse_what_the_cpu_path_refuses(cuda, call,
                                                              match):
    spike.reset_launches()
    with pytest.raises(ValueError, match=match):
        call(cuda)
    assert spike.LAUNCHES["column_sum"] == spike.LAUNCHES["prng_bits"] == 0


def test_column_sum_probe_refuses_past_32_bit_indices(cuda):
    """2^31 elements would overflow the kernel's int indices: the op
    refuses them before any launch."""
    x = torch.empty((2, 1 << 30), device=cuda)
    spike.reset_launches()
    with pytest.raises(ValueError, match=r"at most 2\^31 - 1"):
        spike.column_sum(x)
    assert spike.LAUNCHES["column_sum"] == 0
    del x
    torch.cuda.empty_cache()


def test_prng_probe_is_the_random_stream(cuda):
    """S3's words are ``random.bits`` at any length, past one grid pass."""
    seed = torch.tensor([-5], dtype=torch.int32, device=cuda)
    got = spike.prng_bits(seed, (3, 1 << 20))
    assert torch.equal(got.cpu(), tr.bits(tr.PRNGKey(-5), (3, 1 << 20)))


@pytest.mark.parametrize("wide", [False, True])
def test_bitpair_counts_on_card_equal_cpu(cuda, wide):
    from repro_torch.core.fit_engine import BitPairMLE
    n, m = (40, 36) if wide else (12, 9)
    g = torch.Generator().manual_seed(n)
    src = torch.randint(0, 2 ** n, (300_000,), generator=g)
    dst = torch.randint(0, 2 ** m, (300_000,), generator=g)
    if not wide:
        src, dst = src.to(torch.int32), dst.to(torch.int32)
    want = BitPairMLE(n, m, block=100_000).update(src, dst)
    got = BitPairMLE(n, m, block=100_000).update(src.to(cuda), dst.to(cuda))
    np.testing.assert_array_equal(got.counts, want.counts)


def test_small_fit_on_card_equals_cpu(cuda):
    """The structure fit, schema and VGMs equal the CPU's exactly; the GAN
    and the aligner's qualities to the tolerances of
    ``tests/test_torch_fit.py`` (weights after 10 steps 1e-5, qualities
    0.02); generation from the card's fit launches K2."""
    import dataclasses
    from repro_torch import convert
    from repro_torch.core.aligner import AlignerConfig
    from repro_torch.core.gbdt import GBDTConfig
    from repro_torch.core.pipeline import SyntheticGraphPipeline
    from repro_torch.data.reference import tabformer_like
    table = tabformer_like(n_src=256, n_dst=64, n_edges=2000)
    pipes = {dev: SyntheticGraphPipeline(
        noise=0.03, gan_steps=10,
        aligner_cfg=AlignerConfig(gbdt=GBDTConfig(n_rounds=10)),
        device=dev).fit(*table) for dev in ("cpu", "cuda")}
    cpu, card = pipes["cpu"], pipes["cuda"]
    assert dataclasses.asdict(card.struct) == dataclasses.asdict(cpu.struct)
    s_cpu = convert.state_from_pipeline(cpu)
    s_card = convert.state_from_pipeline(card)
    assert set(s_card) == set(s_cpu)
    for k in s_cpu:
        assert s_card[k].shape == s_cpu[k].shape, k
        if k.startswith(("struct/", "schema/", "gan/vgm/", "pipe/")):
            np.testing.assert_array_equal(s_card[k], s_cpu[k], err_msg=k)
        if k.startswith("gan/g/"):
            np.testing.assert_allclose(s_card[k], s_cpu[k], rtol=0,
                                       atol=1e-5, err_msg=k)
    np.testing.assert_allclose(card.aligner.col_quality,
                               cpu.aligner.col_quality, rtol=0, atol=0.02)
    rs.reset_launches()
    g, c, k = card.generate(seed=0, chunked=True)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["rmat_sample_prng"] > 0
    g_cpu, _, _ = cpu.generate(seed=0, chunked=True, backend="cuda_prng")
    torch.testing.assert_close(g.src.cpu(), g_cpu.src, rtol=0, atol=0)
    assert torch.isfinite(c).all()


def _tree_hashes(path):
    import hashlib
    import os
    return {f: hashlib.md5(open(os.path.join(path, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(path))
            if f.endswith(".npy") or f == "manifest.json"}


def test_dataset_on_card_equals_cpu(cuda, tmp_path):
    """A struct-only dataset written on the card through ``cuda_prng``
    (K2) is byte-identical, shards and manifest, to the CPU's through
    ``cuda_bits``'s plain version: both are the ``pallas_bits`` stream."""
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream import DatasetJob
    fit = KroneckerFit(*TH, n=16, m=13, E=3_000_001, noise=0.03)
    card, cpu = str(tmp_path / "card"), str(tmp_path / "cpu")
    rs.reset_launches()
    job = DatasetJob(fit, card, shard_edges=1 << 20, seed=4,
                     pipeline_depth=2)
    job.run()
    assert job.sampler == "cuda_prng" and job.backend == "pallas_bits"
    assert rs.LAUNCHES["rmat_sample_prng"] == len(job.scheduler.chunks)
    DatasetJob(fit, cpu, shard_edges=1 << 20, seed=4, pipeline_depth=2,
               backend="cuda_bits", device="cpu").run()
    assert _tree_hashes(card) == _tree_hashes(cpu)
    assert job.verify(deep=True) == []


def test_node_features_are_bit_reproducible_on_card(cuda):
    """Two ``node_features`` calls on one graph are bit-equal on the card
    (the edge sums no longer use atomics), and within 1e-4 of the CPU's
    (``test_node_features_on_card_equal_cpu`` holds them equal)."""
    from repro_torch.graph import ops as gops
    gen = torch.Generator().manual_seed(0)
    src = (torch.rand(1 << 20, generator=gen) ** 3 * 5000).to(torch.int32)
    dst = (torch.rand(1 << 20, generator=gen) ** 2 * 3000).to(torch.int32)
    g = gops.Graph(src.to(cuda), dst.to(cuda), 5000, 3000, True)
    a, b = gops.node_features(g), gops.node_features(g)
    assert torch.equal(a.nan_to_num(), b.nan_to_num())
    c = gops.node_features(gops.Graph(src, dst, 5000, 3000, True))
    torch.testing.assert_close(a.cpu(), c, rtol=1e-4, atol=1e-5,
                               equal_nan=True)


@pytest.mark.parametrize("bipartite", [True, False])
def test_node_features_on_card_equal_cpu(cuda, bipartite):
    """``node_features`` on the card equal the CPU's bit for bit: the
    edge sums and PageRank's dangling mass are float64 rounded once to
    float32, and Katz's ``log1p`` is taken in float64, so the two
    devices' orders of addition and math libraries round alike.  The GBDT
    aligner's rank matching moves many rows for one moved prediction, so
    this is what keeps aligned rows equal on card and CPU at scale."""
    from repro_torch.graph import ops as gops
    gen = torch.Generator().manual_seed(1)
    n_src, n_dst = (5000, 3000) if bipartite else (6000, 6000)
    src = (torch.rand(1 << 20, generator=gen) ** 3 * n_src).to(torch.int32)
    dst = (torch.rand(1 << 20, generator=gen) ** 2 * n_dst).to(torch.int32)
    a = gops.node_features(gops.Graph(src.to(cuda), dst.to(cuda), n_src,
                                      n_dst, bipartite))
    b = gops.node_features(gops.Graph(src, dst, n_src, n_dst, bipartite))
    assert torch.equal(a.cpu().view(torch.int32), b.view(torch.int32))


def test_reservoir_hash_on_card_is_uint64_mix64(cuda):
    """The reservoir's priorities on the card: splitmix64 in int64 equals
    numpy's uint64 ``_mix64`` on every bit pattern, ids ≥ 2^63 included,
    and the bit-63-flipped priorities sort in their uint64 order."""
    from repro_torch.core import fit_engine as fe
    rng = np.random.default_rng(0)
    u = rng.integers(0, 1 << 64, 1 << 20, dtype=np.uint64)
    u[:4] = [0, (1 << 63) - 1, 1 << 63, (1 << 64) - 1]
    want = fe._mix64(u)
    got = fe._mix64_t(torch.from_numpy(u.view(np.int64)).to(cuda))
    np.testing.assert_array_equal(got.cpu().numpy().view(np.uint64), want)
    order = torch.sort(got ^ fe._signed(fe._SIGN), stable=True).indices
    np.testing.assert_array_equal(want[order.cpu().numpy()], np.sort(want))


@pytest.mark.parametrize("stratified", [False, True])
def test_fit_accumulators_on_card_equal_cpu(cuda, stratified):
    """The dense degree sketch, the bit-pair counts and the reservoir's
    rows and columns equal the CPU's, chunk for chunk."""
    from repro_torch.core import fit_engine as fe
    rng = np.random.default_rng(1)
    n, n_nodes = 600_000, 1 << 16
    src = rng.integers(0, n_nodes, n).astype(np.int32)
    dst = (rng.random(n) ** 3 * n_nodes).astype(np.int32)
    cont = rng.normal(size=(n, 2)).astype(np.float32)
    cat = rng.integers(0, 5, size=(n, 1)).astype(np.int32)
    sizes, out = [200_000, 1, 199_999, 200_000], []
    for dev in (cuda, torch.device("cpu")):
        sk = fe.DegreeSketch(n_nodes, 512, device=dev)
        mle = fe.BitPairMLE(16, 16, block=100_000)
        res = fe.ReservoirSample(20_000, seed=3, stratified=stratified,
                                 total_rows=n, device=dev)
        off = 0
        for s in sizes:
            sl = slice(off, off + s)
            d = torch.from_numpy(dst[sl]).to(dev)
            sk.update(d)
            mle.update(torch.from_numpy(src[sl]).to(dev), d)
            res.update(fe.FitChunk(src[sl], d, cont[sl], cat[sl], off))
            off += s
        out.append((sk.finalize(), mle.counts, res.finalize()))
    ((h_a, m_a), c_a, r_a), ((h_b, m_b), c_b, r_b) = out
    np.testing.assert_array_equal(h_a, h_b)
    assert m_a == m_b
    np.testing.assert_array_equal(c_a, c_b)
    for k in ("rows", "src", "dst", "cont", "cat"):
        np.testing.assert_array_equal(r_a[k], r_b[k], err_msg=k)
    assert r_a["provenance"] == r_b["provenance"]


def test_fit_json_on_card_equals_cpu(cuda, tmp_path):
    """``accumulate`` + ``fit_structure_streamed`` on the card give the
    CPU's fit JSON byte for byte (dense sketches at 2^16 nodes, the
    calibration samples on the ``reference`` stream)."""
    from repro_torch.core import fit_engine as fe
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream import DatasetFitSource, DatasetJob
    path = str(tmp_path / "ds")
    DatasetJob(KroneckerFit(*TH, n=16, m=15, E=2_000_000), path,
               shard_edges=1 << 19, seed=1).run()
    texts = []
    for dev in ("cuda", "cpu"):
        stats = fe.accumulate(DatasetFitSource(path, chunk_rows=300_000),
                              sample_rows=10_000, device=dev)
        texts.append(fe.fit_to_json(*fe.fit_structure_streamed(
            stats, noise=0.03, device=dev)))
    assert texts[0] == texts[1]


def _close_stat(got, want):
    if isinstance(want, int):
        assert got == want and isinstance(got, int)
    else:
        assert got == pytest.approx(want, rel=1e-9, abs=1e-12)


def test_scores_and_statistics_on_card_equal_cpu(cuda):
    """``evaluate_all`` and every graph statistic on the card equal the
    CPU's on the same tensors: integers exactly, floats within 1e-9
    relative (1e-12 absolute near 0)."""
    from repro_torch.core import metrics
    from repro_torch.data.reference import tabformer_like
    from repro_torch.graph import ops as gops
    g_r, c_r, k_r = tabformer_like()
    g_s, c_s, k_s = tabformer_like(seed=7, n_src=8192, n_edges=200_000)
    want = metrics.evaluate_all(g_r, c_r, k_r, g_s, c_s, k_s, device="cpu")
    got = metrics.evaluate_all(g_r, c_r, k_r, g_s, c_s, k_s, device=cuda)
    for k in want:
        _close_stat(got[k], want[k])
    gc = gops.Graph(g_s.src.to(cuda), g_s.dst.to(cuda), g_s.n_src,
                    g_s.n_dst, True)
    for stat in ("triangle_count", "wedge_count", "global_clustering",
                 "degree_assortativity", "rel_edge_distribution_entropy",
                 "largest_connected_component"):
        _close_stat(getattr(gops, stat)(gc), getattr(gops, stat)(g_s))
    np.testing.assert_array_equal(gops.hop_plot(gc), gops.hop_plot(g_s))
    deg = torch.cat([gops.out_degrees(g_s), gops.in_degrees(g_s)])
    for fn in (gops.gini_coefficient, gops.powerlaw_exponent):
        _close_stat(fn(deg.to(cuda)), fn(deg))


def test_triangle_count_on_card_known_graph(cuda):
    """Disjoint cliques K_3..K_40 plus duplicate and reversed edges and
    self-loops: Σ C(k, 3) triangles, on the card and the CPU, in one batch
    and in many."""
    from repro_torch.graph import ops as gops
    src, dst, base, want = [], [], 0, 0
    for k in range(3, 41):
        a, b = np.triu_indices(k, 1)
        src += list(a + base) + list(b + base) + [base]
        dst += list(b + base) + list(a + base) + [base]
        base += k
        want += k * (k - 1) * (k - 2) // 6
    g = gops.Graph(torch.tensor(src, dtype=torch.int32, device=cuda),
                   torch.tensor(dst, dtype=torch.int32, device=cuda),
                   base, base)
    assert gops.triangle_count(g) == want
    batch = gops.EXPAND_BATCH
    try:
        gops.EXPAND_BATCH = 97
        assert gops.triangle_count(g) == want
    finally:
        gops.EXPAND_BATCH = batch
    assert gops.largest_connected_component(g) == 40


def test_gcn_loss_on_card_close_to_cpu(cuda):
    """20 GCN epochs on ``cora_like`` by ``train_node_classifier`` on the
    card and on the CPU, both from ``init_gnn(PRNGKey(0))``, whose weights
    on the two are within 1e-6 (the port's normals' tolerance): losses
    within 1e-4 and the same test accuracy to within one node; two runs
    on the card give the same losses (the message sums are sorted
    ``segment_reduce``, not atomics)."""
    from repro_torch import random as tr
    from repro_torch.data.reference import cora_like
    from repro_torch.models import gnn
    g, cont, cat = cora_like()
    cfg = gnn.GNNConfig(hidden=128)
    for a, b in zip(*(gnn.init_gnn(tr.PRNGKey(0), cfg, cont.shape[1],
                                   device=dev).parameters()
                      for dev in ("cpu", cuda))):
        np.testing.assert_allclose(b.detach().cpu().numpy(),
                                   a.detach().numpy(), rtol=0, atol=1e-6)
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", cuda), ("card2", cuda)):
        runs[name] = gnn.train_node_classifier(
            g, cont, cat[:, 0], cfg, epochs=20, device=dev)
    np.testing.assert_allclose(runs["card"][2], runs["cpu"][2], rtol=0,
                               atol=1e-4)
    np.testing.assert_array_equal(runs["card"][2], runs["card2"][2])
    assert abs(runs["card"][1] - runs["cpu"][1]) <= 0.01


# -- the baseline generators --------------------------------------------------

def _baseline_graph():
    from repro_torch.data.reference import tabformer_like
    return tabformer_like(n_src=512, n_dst=64, n_edges=4000)


@pytest.mark.parametrize("kind", ["er", "sbm-powerlaw", "sbm-empirical"])
@pytest.mark.parametrize("scale", [1, 4])
def test_baseline_ids_on_card_equal_cpu(cuda, kind, scale):
    from repro_torch.core.baselines import ERGenerator, SBMGenerator
    from repro_torch.graph.ops import Graph
    g, _, _ = _baseline_graph()
    out = []
    for dev in ("cpu", cuda):
        gd = Graph(g.src.to(dev), g.dst.to(dev), g.n_src, g.n_dst,
                   g.bipartite)
        gen = (ERGenerator(device=dev) if kind == "er" else SBMGenerator(
            degree_mode=kind.split("-")[1], device=dev)).fit(gd)
        out.append(gen.sample(np.random.default_rng(3), scale))
    want, got = out
    assert got.src.is_cuda and got.src.dtype == torch.int32
    assert torch.equal(got.src.cpu(), want.src)
    assert torch.equal(got.dst.cpu(), want.dst)


@pytest.mark.parametrize("kind,bandwidth", [("kde", None), ("kde", 0.3),
                                            ("random", None)])
def test_baseline_features_on_card_equal_cpu(cuda, kind, bandwidth):
    from repro_torch.core.features import (KDEFeatureGenerator,
                                           RandomFeatureGenerator)
    from repro_torch.tabular.schema import infer_schema
    _, cont, cat = _baseline_graph()
    schema = infer_schema(cont, cat)
    out = []
    for dev in ("cpu", cuda):
        gen = (KDEFeatureGenerator(schema, bandwidth, device=dev)
               if kind == "kde" else RandomFeatureGenerator(schema, dev))
        out.append(gen.fit(cont, cat).sample(np.random.default_rng(5),
                                             100_003))
    (wc, wk), (c, k) = out
    assert c.is_cuda and c.dtype == torch.float32 and k.dtype == torch.int32
    assert torch.equal(c.cpu().view(torch.int32), wc.view(torch.int32))
    assert torch.equal(k.cpu(), wk)


@pytest.mark.parametrize("n_src,n_dst,n_edges", [(1 << 20, 1 << 20, 1 << 20),
                                                 (1000, 37, 99_999)])
def test_erdos_renyi_on_card_equals_cpu(cuda, n_src, n_dst, n_edges):
    from repro_torch.core.rmat import sample_erdos_renyi
    s, d = sample_erdos_renyi(tr.PRNGKey(4), n_src, n_dst, n_edges,
                              device=cuda)
    ws, wd = sample_erdos_renyi(tr.PRNGKey(4), n_src, n_dst, n_edges,
                                device="cpu")
    assert s.is_cuda and s.dtype == torch.int32
    assert torch.equal(s.cpu(), ws) and torch.equal(d.cpu(), wd)


def test_timeit_covers_the_draws_device_time(cuda):
    """``benchmarks.common.timeit`` of a K2 draw ends on the device: each
    timed call records CUDA events around its draw, and the host time per
    call is at least the device time between them (the median of the
    host times at least the median of the event times, since each call's
    host time covers its own events).  A ``timeit`` that timed only the
    launches would give tens of microseconds against milliseconds."""
    from repro_torch.benchmarks.common import timeit
    L, E, repeats = 24, 1 << 26, 3
    th = np.tile(np.asarray(TH, np.float32), (L, 1))
    be = sampler.get_backend("cuda_prng")
    events = []

    def draw():
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        be.sample(tr.PRNGKey(3), th, L, L, E, device=cuda)
        stop.record()
        events.append((start, stop))
    rs.reset_launches()
    host_us = timeit(draw, repeats=repeats, warmup=1, device=cuda)
    torch.cuda.synchronize()
    assert rs.LAUNCHES["rmat_sample_prng"] == repeats + 1
    device_us = sorted(a.elapsed_time(b) * 1e3 for a, b in events[1:])
    assert host_us >= device_us[repeats // 2] > 1000


def test_fig8_on_card_under_its_bound(cuda, tmp_path, monkeypatch):
    """Fig. 8 on the card times all three backends (K1 and K2 each
    launched), each at most its H100 bound; the card's ids equal the
    plain version's for the same key."""
    from repro_torch.benchmarks import fig8_throughput as fig8
    monkeypatch.chdir(tmp_path)
    rs.reset_launches()
    rows = {r["name"]: r for r in fig8.run(fast=True, device="cuda")}
    assert rs.LAUNCHES["rmat_sample_bits"] >= 2
    assert rs.LAUNCHES["rmat_sample_prng"] >= 2
    for name in sampler.registered_backends():
        derived = dict(kv.split("=") for kv in
                       rows[f"fig8/{name}"]["derived"].split(";"))
        assert float(derived["eps"]) > 0
        assert 0 < float(derived["of_bound"]) <= 1.0, (name, derived)
    th = fig8.thetas()
    E = fig8.E_FAST["cuda_bits"]
    L = fig8.N_LEVELS
    got = [sampler.get_backend(n).sample(tr.PRNGKey(1), th, L, L, E,
                                         device=cuda)
           for n in ("cuda_bits", "cuda_prng")]
    want = sampler.get_backend("cuda_bits").sample(tr.PRNGKey(1), th, L, L,
                                                   E, device="cpu")
    for ids in got:
        for a, b in zip(ids, want):
            torch.testing.assert_close(a.cpu(), b, rtol=0, atol=0)
