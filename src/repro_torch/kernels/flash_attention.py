"""Wrapper over the hand-written flash-attention CUDA kernels.

Two kernels replace the Pallas TPU kernel ``flash_attention`` of the JAX
package (online softmax, causal early exit, grouped-query attention
through the ``h // group`` head map, float32 accumulation).  Which one a
call takes is decided from its dtype and head dim before the launch
(``route``), never after a failure:

* ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bfloat16 with head dim
  64 or 128, the head dims of every dense config of the port.  Both
  products run on Hopper's tensor cores (wgmma), the K/V tiles arrive by
  TMA; p enters the p·v product as a bf16 pair (hi, lo) in two products
  into one float32 accumulator, within 2^-16 of the float32 p.
* ``"fma"`` (``csrc/flash_attention.cu``): float32, and bfloat16 with head
  dim 16 or 32.  Scalar float32 FMAs, so float32 stays within 2e-5 of the
  plain version, which no tensor-core type (TF32, bf16) can meet.

``flash_attention`` checks its inputs; for tensors on the CPU it takes the
plain version ``ref.attention_ref``, for CUDA tensors it launches its
route's kernel on torch's current stream or raises.
``LAUNCHES["flash_attention"]`` counts the launches of both routes,
``LAUNCHES["flash_attention_<route>"]`` those of each.

The Pallas kernel's ``blk_q``/``blk_k`` cut the sequence into blocks and
must divide it; the contract is kept (a ragged sequence raises), while the
CUDA kernels walk their own tiles and mask the ragged edge: the result
does not depend on the blocking beyond float32 summation order.  There
must be at least one key (T >= 1).
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict

import torch

from repro_torch.kernels import _build, ref

#: launches since the last ``reset_launches``: both routes, then each
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_fma": 0,
                            "flash_attention_wgmma": 0}

CSRC = Path(__file__).with_name("csrc")
SOURCE = CSRC / "flash_attention.cu"
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
HEAD_DIMS = (16, 32, 64, 128)
WGMMA_HEAD_DIMS = (64, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i, i,
                                        ctypes.c_float, p]
    lib.flash_attention_fwd.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def _declare_wgmma(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_wgmma_fwd.argtypes = [p, p, p, p, i, i, i, i, i, i, i,
                                    ctypes.c_float, p]
    lib.flash_wgmma_fwd.restype = i
    lib.flash_wgmma_error_string.argtypes = [i]
    lib.flash_wgmma_error_string.restype = ctypes.c_char_p


LIBRARY = _build.CudaLibrary(SOURCE, _declare)
WGMMA_LIBRARY = _build.CudaLibrary(WGMMA_SOURCE, _declare_wgmma)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def route(dtype: torch.dtype, d: int) -> str:
    """The kernel a CUDA call of this dtype and head dim launches."""
    return ("wgmma" if dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS
            else "fma")


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
    if T < 1:
        raise ValueError("attention needs at least one key (T >= 1)")
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
    return launch(q, k, v, route(q.dtype, q.shape[-1]), causal=causal,
                  group=group)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kernel: str,
           *, causal: bool, group: int) -> torch.Tensor:
    """Launches the named route's kernel on CUDA tensors that
    ``flash_attention`` has checked (the fma kernel takes every head dim
    and both dtypes, the wgmma kernel bf16 with d 64 or 128)."""
    Hq, S, d = q.shape
    Hkv, T, _ = k.shape
    if kernel not in ("wgmma", "fma"):
        raise ValueError(f"unknown flash-attention kernel {kernel!r}")
    if kernel == "wgmma" and (q.dtype != torch.bfloat16
                              or d not in WGMMA_HEAD_DIMS):
        raise ValueError(f"the wgmma kernel takes bfloat16 with head dim in "
                         f"{WGMMA_HEAD_DIMS}, got {q.dtype}, {d}")
    if q.device.type != "cuda":
        raise ValueError(f"tensors on {q.device}: the kernel takes CPU "
                         "tensors (plain version) or CUDA tensors")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if kernel == "wgmma" and t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned for TMA")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    lib = (WGMMA_LIBRARY if kernel == "wgmma" else LIBRARY).lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        if kernel == "wgmma":
            rc = lib.flash_wgmma_fwd(*ptrs, Hq, Hkv, S, T, d, group,
                                     int(causal), 1.0 / d ** 0.5, stream)
        else:
            rc = lib.flash_attention_fwd(*ptrs, _DTYPES[q.dtype], Hq, Hkv, S,
                                         T, d, group, int(causal),
                                         1.0 / d ** 0.5, stream)
    if rc != 0:
        err = (lib.flash_wgmma_error_string if kernel == "wgmma"
               else lib.flash_attention_error_string)
        raise RuntimeError(f"flash_attention ({kernel}): launch failed: "
                           f"{err(rc).decode()} ({rc})")
    LAUNCHES["flash_attention"] += 1
    LAUNCHES[f"flash_attention_{kernel}"] += 1
    return out
