"""The port's flash attention against the JAX package's Pallas kernel.

On this CPU the port's ``ops.attention`` takes its plain version
(``ref.attention_ref``); the JAX side runs the Pallas kernel in interpret
mode, as its own tests do.  Inputs are made with numpy from a seed and
handed to both.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in float32 (online vs full softmax
differ in summation order only), 2e-2 in bfloat16 (one bf16 rounding of
outputs of magnitude ~1).  The CUDA kernel is checked against the plain
version in ``test_torch_cuda.py``."""
import math

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.convert import tensor_from_numpy
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

TOL = {"float32": 2e-5, "bfloat16": 2e-2}


def _inputs(H, KV, S, T, dh, dtype, seed=3):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((H, S, dh), (KV, T, dh), (KV, T, dh))]
    if dtype == "bfloat16":
        arrs = [a.astype(ml_dtypes.bfloat16) for a in arrs]
    return arrs


def _err(port, jax_out):
    return float(np.abs(port.float().numpy()
                        - np.asarray(jax_out, np.float32)).max())


@pytest.mark.parametrize("H,KV,S,T,dh,causal,dtype", [
    (4, 4, 256, 256, 64, True, "float32"),
    (8, 2, 128, 128, 32, True, "float32"),     # GQA, group 4
    (4, 4, 128, 128, 64, False, "float32"),
    (4, 1, 256, 256, 64, True, "bfloat16"),    # GQA, group 4
    (2, 2, 512, 512, 128, True, "float32"),
])
def test_attention_matches_pallas(H, KV, S, T, dh, causal, dtype):
    g = H // KV
    q, k, v = _inputs(H, KV, S, T, dh, dtype)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, group=g, blk_q=64, blk_k=64)
    got = ops.attention(*map(tensor_from_numpy, (q, k, v)), causal=causal,
                        group=g, blk_q=64, blk_k=64)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == (H, S, dh)
    assert _err(got, want) < TOL[dtype]


@pytest.mark.parametrize("bq,bk", [(32, 32), (64, 128), (128, 64),
                                   (256, 256)])
def test_attention_block_shape_sweep(bq, bk):
    q, k, v = _inputs(2, 2, 256, 256, 64, "float32", seed=0)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=True, blk_q=bq, blk_k=bk)
    got = ops.attention(*map(tensor_from_numpy, (q, k, v)), causal=True,
                        blk_q=bq, blk_k=bk)
    assert _err(got, want) < TOL["float32"]


@pytest.mark.parametrize("shapes,kw,match", [
    (((4, 128, 48), (4, 128, 48)), {}, "head dim"),
    (((4, 100, 64), (4, 100, 64)), {}, "multiples"),
    (((4, 128, 64), (4, 128, 64)), {"blk_k": 96}, "multiples"),
    (((4, 128, 64), (2, 128, 64)), {"group": 1}, "group"),
    (((4, 128, 64), (4, 0, 64)), {}, "at least one key"),
])
def test_attention_rejects_what_the_kernel_does_not_take(shapes, kw, match):
    qs, ks = shapes
    q, k = torch.zeros(qs), torch.zeros(ks)
    with pytest.raises(ValueError, match=match):
        ops.attention(q, k, k.clone(), **kw)


def test_attention_rejects_mixed_dtypes():
    q = torch.zeros((2, 128, 64))
    k = torch.zeros((2, 128, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="float32 or all bfloat16"):
        ops.attention(q, k, k)


@pytest.mark.parametrize("dtype,dh,want", [
    (torch.bfloat16, 64, "wgmma"), (torch.bfloat16, 128, "wgmma"),
    (torch.bfloat16, 32, "fma"), (torch.bfloat16, 16, "fma"),
    (torch.float32, 64, "fma"), (torch.float32, 128, "fma")])
def test_route_follows_dtype_and_head_dim(dtype, dh, want):
    """bf16 at d 64/128 goes to the tensor cores, the rest to FMAs."""
    assert fa.route(dtype, dh) == want


@pytest.mark.parametrize("kernel,dtype,dh,match", [
    ("wgmma", torch.float32, 64, "bfloat16"),
    ("wgmma", torch.bfloat16, 32, "head dim"),
    ("mma", torch.bfloat16, 64, "unknown"),
    ("fma", torch.bfloat16, 64, "CUDA tensors"),
])
def test_launch_rejects_calls_its_kernel_does_not_take(kernel, dtype, dh,
                                                       match):
    q = torch.zeros((2, 128, dh), dtype=dtype)
    with pytest.raises(ValueError, match=match):
        fa.launch(q, q, q, kernel, causal=True, group=1)


def test_cpu_call_launches_no_kernel():
    fa.reset_launches()
    q = torch.randn((2, 128, 16))
    ops.attention(q, q, q)
    assert fa.LAUNCHES["flash_attention"] == 0


def _tensor_core_model(q, k, v, *, causal, group, tile=128):
    """The wgmma kernel's arithmetic on the CPU: bf16 q, k, v; float32
    scores over 128-key tiles in the log2 domain (scale times log2 e);
    NEG_INF = -1e30 where col > row; online softmax with a float32 running
    (m, l, acc); p as a bf16 pair, hi = bf16(p) and lo = bf16(p - hi),
    in two p·v products into the float32 acc, l summed from the float32 p;
    out = acc / max(l, 1e-20) rounded to bf16."""
    Hq, S, d = q.shape
    T = k.shape[1]
    kk = k.float().repeat_interleave(group, dim=0)
    vv = v.float().repeat_interleave(group, dim=0)
    scale_log2 = math.log2(math.e) / math.sqrt(d)
    m = torch.full((Hq, S), -1e30)
    l = torch.zeros((Hq, S))
    acc = torch.zeros((Hq, S, d))
    rows = torch.arange(S)[:, None]
    for c0 in range(0, T, tile):
        s = torch.einsum("hsd,htd->hst", q.float(),
                         kk[:, c0:c0 + tile]) * scale_log2
        if causal:
            cols = c0 + torch.arange(s.shape[-1])[None, :]
            s = s.masked_fill(cols > rows, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        v_t = vv[:, c0:c0 + tile]
        acc = (acc * alpha[..., None] + torch.einsum("hst,htd->hsd", hi, v_t)
               + torch.einsum("hst,htd->hsd", lo, v_t))
        m = m_new
    return (acc / l.clamp_min(1e-20)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("KV,group", [(2, 1), (2, 4), (1, 16)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dh", [64, 128])
def test_tensor_core_arithmetic_matches_pallas(dh, causal, KV, group):
    """p as a bf16 (hi, lo) pair in the p·v products stays within the bf16
    tolerance of the Pallas kernel (float32 p), across two key tiles."""
    H, S = KV * group, 256
    q, k, v = _inputs(H, KV, S, S, dh, "bfloat16", seed=dh + group)
    want = jops.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=causal, group=group, blk_q=128, blk_k=128)
    got = _tensor_core_model(*map(tensor_from_numpy, (q, k, v)),
                             causal=causal, group=group)
    assert _err(got, want) < TOL["bfloat16"]


#: V's scale in the early-row checks: early causal rows then reach |out| of
#: 4–32, where one bf16 step is 2^-5–2^-3
V_SCALE = 8.0


def _early_row_excess(got, want, v_scale=V_SCALE):
    """max |got − want| over its limit: one bf16 step at |want|,
    ``2**(floor(log2|want|) − 7)``, where |want| ≥ 4; elsewhere the bf16
    tolerance times the V scale (attention is linear in V).  At most 1
    passes."""
    got, want = got.float(), want.float()
    a = want.abs()
    step = torch.exp2(torch.floor(torch.log2(a.clamp_min(4.0))) - 7)
    limit = torch.where(a >= 4, step,
                        torch.full_like(a, TOL["bfloat16"] * v_scale))
    return ((got - want).abs() / limit).max().item()


@pytest.mark.parametrize("dh", [64, 128])
def test_tensor_core_arithmetic_holds_early_causal_rows(dh):
    """With V scaled by 8 the early causal rows (few keys, each p weighing
    much) reach |out| ≥ 4; the kernel's arithmetic stays within one bf16
    step there of the Pallas kernel in float32 on the same bf16 values."""
    KV, group, S = 4, 4, 256
    q, k, v = _inputs(KV * group, KV, S, S, dh, "bfloat16", seed=dh)
    v = (v.astype(np.float32) * V_SCALE).astype(ml_dtypes.bfloat16)
    want = jops.attention(*(jnp.asarray(a.astype(np.float32))
                            for a in (q, k, v)),
                          causal=True, group=group, blk_q=128, blk_k=128)
    want = torch.from_numpy(np.array(want))
    assert (want[:, :16].abs() >= 4).any()
    got = _tensor_core_model(*map(tensor_from_numpy, (q, k, v)),
                             causal=True, group=group)
    assert _early_row_excess(got, want) <= 1.0
