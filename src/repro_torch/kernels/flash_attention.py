"""Wrapper over the hand-written flash-attention CUDA kernel.

``csrc/flash_attention.cu`` replaces the Pallas TPU kernel
``flash_attention`` of the JAX package (online softmax, causal early exit,
grouped-query attention through the ``h // group`` head map, float32
accumulation).  ``flash_attention`` checks its inputs; for tensors on the
CPU it takes the plain version ``ref.attention_ref``, for CUDA tensors it
launches the kernel on torch's current stream or raises.
``LAUNCHES["flash_attention"]`` counts the launches.

The Pallas kernel's ``blk_q``/``blk_k`` cut the sequence into blocks and
must divide it; the contract is kept (a ragged sequence raises), while the
CUDA kernel walks its own 64 x 64 tiles: the result does not depend on the
blocking beyond float32 summation order.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

#: launches of the kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"flash_attention": 0}

SOURCE = Path(__file__).with_name("csrc") / "flash_attention.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


LIBRARY = _build.CudaLibrary(SOURCE, _declare)


def reset_launches() -> None:
    LAUNCHES["flash_attention"] = 0


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, blk_q: int,
           blk_k: int, group: int) -> None:
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape:
        raise ValueError(f"q must be (Hq, S, d) and k, v one (Hkv, T, d) "
                         f"shape, got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    Hq, S, d = q.shape
    Hkv, T, dk = k.shape
    if dk != d or d not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS} and equal "
                         f"in q and k, got {d} and {dk}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must all be float32 or all bfloat16, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if group < 1 or Hq != Hkv * group:
        raise ValueError(f"Hq={Hq} must equal Hkv={Hkv} x group={group}")
    if blk_q < 1 or blk_k < 1 or S % blk_q or T % blk_k:
        raise ValueError(f"S={S} and T={T} must be multiples of blk_q="
                         f"{blk_q} and blk_k={blk_k}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q on {q.device}, k on {k.device}, v on "
                         f"{v.device}: one device for all")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, blk_q: int = 128, blk_k: int = 128,
                    group: int = 1) -> torch.Tensor:
    """q: (Hq, S, d), k/v: (Hkv, T, d) with Hq == Hkv·group → (Hq, S, d)
    in q's dtype, with scores scaled by 1/sqrt(d)."""
    _check(q, k, v, blk_q, blk_k, group)
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal, group=group)
    if q.device.type != "cuda":
        raise ValueError(f"tensors on {q.device}: the kernel takes CPU "
                         "tensors (plain version) or CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    Hq, S, d = q.shape
    Hkv, T, _ = k.shape
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = LIBRARY.lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], Hq, Hkv, S, T, d, group, int(causal),
            1.0 / d ** 0.5, stream)
    if rc != 0:
        msg = LIBRARY.lib().flash_attention_error_string(rc).decode()
        raise RuntimeError(f"flash_attention: launch failed: {msg} ({rc})")
    LAUNCHES["flash_attention"] += 1
    return out
