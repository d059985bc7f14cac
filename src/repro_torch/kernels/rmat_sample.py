"""Wrappers over the hand-written R-MAT CUDA kernels.

The three kernels (``csrc/rmat_sample.cu``) replace the Pallas TPU kernels
of the JAX package one for one and compute one descend; they differ in
where each level's uniform comes from:

* ``rmat_sample_uniforms``: float32 uniforms read from device memory;
* ``rmat_sample_bits``: uint32 words read from device memory and turned
  into uniforms by the mantissa trick (one body with the uniforms kernel);
* ``rmat_sample_prng``: the words computed in registers by threefry2x32,
  the exact words ``rmat_sample_bits`` would read for
  ``random.bits(key, (L, stride))``, so its ids equal the bits kernel's.
  Its own body runs eight edges a thread (one in a launch too small to
  fill the card) and compares each word's mantissa with integer level
  thresholds (``ref.unit_threshold`` and
  ``ref.rmat_prng_thresholds_ref`` mirror it on the CPU).

Every wrapper checks its inputs; for tensors on the CPU it takes the
plain version in ``kernels/ref.py``, for CUDA tensors it launches the
kernel on torch's current stream or raises.  ``LAUNCHES`` counts the
launches of each kernel.

The kernels are compiled at first use by ``kernels._build``, from the
source in this package.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Dict, Optional, Tuple

import torch

from repro_torch import random as trandom
from repro_torch.core.descend import LO_BITS, IdParts
from repro_torch.kernels import _build, ref

#: launches of each kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"rmat_sample_uniforms": 0,
                            "rmat_sample_bits": 0,
                            "rmat_sample_prng": 0}

SOURCE = Path(__file__).with_name("csrc") / "rmat_sample.cu"


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_uint)
    for name in ("rmat_uniforms", "rmat_bits"):
        fn = getattr(lib, name)
        fn.argtypes = [p, p, i, i, ll, ll, p, p, p, p, p]
        fn.restype = i
    lib.rmat_prng.argtypes = [p, u, u, i, i, ll, ll, p, p, p, p, p]
    lib.rmat_prng.restype = i
    lib.rmat_error_string.argtypes = [i]
    lib.rmat_error_string.restype = ctypes.c_char_p


LIBRARY = _build.CudaLibrary(SOURCE, _declare)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _lib() -> ctypes.CDLL:
    return LIBRARY.lib()


def _check_thetas(thetas: torch.Tensor, n: int, m: int) -> None:
    L = max(n, m)
    if thetas.dtype != torch.float32 or tuple(thetas.shape) != (L, 4) \
            or not thetas.is_contiguous():
        raise ValueError(f"thetas must be a contiguous float32 ({L}, 4) "
                         f"tensor, got {thetas.dtype} {tuple(thetas.shape)}")
    if L > 64 or min(n, m) < 0:
        raise ValueError(f"levels n={n}, m={m} out of range (max 64)")


def _check_levels_input(x: torch.Tensor, dtype: torch.dtype,
                        thetas: torch.Tensor, n: int, m: int,
                        what: str) -> None:
    _check_thetas(thetas, n, m)
    L = max(n, m)
    if x.dtype != dtype or x.dim() != 2 or x.shape[0] != L \
            or not x.is_contiguous():
        raise ValueError(f"{what} must be a contiguous {dtype} (L={L}, E) "
                         f"tensor, got {x.dtype} {tuple(x.shape)}")
    if x.device != thetas.device:
        raise ValueError(f"{what} on {x.device} but thetas on "
                         f"{thetas.device}")


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"tensor on {t.device}: the kernels take CPU "
                         "tensors (plain version) or CUDA tensors")


def _outputs(n: int, m: int, E: int, device) -> Tuple[IdParts, IdParts]:
    def word():
        return torch.empty(E, dtype=torch.int32, device=device)
    src = IdParts(word() if n > LO_BITS else None, word())
    dst = IdParts(word() if m > LO_BITS else None, word())
    return src, dst


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def _launch(name: str, fn, head, n: int, m: int, E: int, stride: int,
            device) -> Tuple[IdParts, IdParts]:
    src, dst = _outputs(n, m, E, device)
    if E == 0:
        return src, dst
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*head, n, m, E, stride, _ptr(src.hi), _ptr(src.lo),
                _ptr(dst.hi), _ptr(dst.lo), stream)
    if rc != 0:
        msg = _lib().rmat_error_string(rc).decode()
        raise RuntimeError(f"{name}: launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return src, dst


def rmat_sample_uniforms(thetas: torch.Tensor, uniforms: torch.Tensor,
                         n: int, m: int) -> Tuple[IdParts, IdParts]:
    """thetas: (L, 4) float32; uniforms: (L, E) float32."""
    _check_levels_input(uniforms, torch.float32, thetas, n, m, "uniforms")
    if uniforms.device.type == "cpu":
        return ref.rmat_parts_ref(thetas, uniforms, n, m)
    _require_cuda(uniforms)
    E = uniforms.shape[1]
    return _launch("rmat_sample_uniforms", _lib().rmat_uniforms,
                   (thetas.data_ptr(), uniforms.data_ptr()), n, m, E, E,
                   uniforms.device)


def rmat_sample_bits(thetas: torch.Tensor, bits: torch.Tensor, n: int,
                     m: int) -> Tuple[IdParts, IdParts]:
    """thetas: (L, 4) float32; bits: (L, E) uint32 words as int32."""
    _check_levels_input(bits, torch.int32, thetas, n, m, "bits")
    if bits.device.type == "cpu":
        return ref.rmat_parts_ref(thetas, ref.bits_to_uniform_ref(bits),
                                  n, m)
    _require_cuda(bits)
    E = bits.shape[1]
    return _launch("rmat_sample_bits", _lib().rmat_bits,
                   (thetas.data_ptr(), bits.data_ptr()), n, m, E, E,
                   bits.device)


def rmat_sample_prng(key: torch.Tensor, thetas: torch.Tensor, n: int,
                     m: int, n_edges: int, stride: int
                     ) -> Tuple[IdParts, IdParts]:
    """Ids of the first ``n_edges`` edges of ``rmat_sample_bits(thetas,
    random.bits(key, (L, stride)))``, with the bits made in registers.
    ``key`` is a ``random`` key; the device is ``thetas``'s."""
    _check_thetas(thetas, n, m)
    if not 0 <= n_edges <= stride:
        raise ValueError(f"n_edges={n_edges} must lie in [0, stride="
                         f"{stride}]")
    if thetas.device.type == "cpu":
        return ref.rmat_prng_ref(key, thetas, n, m, n_edges, stride)
    _require_cuda(thetas)
    k0, k1 = trandom.key_words(key)
    return _launch("rmat_sample_prng", _lib().rmat_prng,
                   (thetas.data_ptr(), k0, k1), n, m, n_edges, stride,
                   thetas.device)
