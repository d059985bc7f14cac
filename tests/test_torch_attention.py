"""The port's flash attention against the JAX package's Pallas kernel.

On this CPU the port's ``ops.attention`` takes its plain version
(``ref.attention_ref``); the JAX side runs the Pallas kernel in interpret
mode, as its own tests do.  Inputs are made with numpy from a seed and
handed to both.  Tolerances are the reference's own
(``tests/test_kernels.py``): 2e-5 in float32 (online vs full softmax
differ in summation order only), 2e-2 in bfloat16 (one bf16 rounding of
outputs of magnitude ~1).  The CUDA kernel is checked against the plain
version in ``test_torch_cuda.py``."""
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


def test_cpu_call_launches_no_kernel():
    fa.reset_launches()
    q = torch.randn((2, 128, 16))
    ops.attention(q, q, q)
    assert fa.LAUNCHES["flash_attention"] == 0
