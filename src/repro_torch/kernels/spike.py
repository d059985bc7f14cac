"""Wrappers over the CUDA counterparts of the Pallas toolchain probes.

``csrc/spike.cu`` replaces the four kernels of ``scripts/spike_pallas.py``
one for one, at that script's shapes:

* ``add`` (S1, ``add_kernel``): float32 ``x + y``;
* ``double_blocks`` (S2, ``blk_kernel``): ``2 * x`` with one CTA per block
  of ``block_rows`` rows, as the script's grid of row blocks cuts it;
* ``prng_bits`` (S3, ``prng_kernel``): random bits from an int32 seed that
  the kernel reads.  The TPU's hardware bits cannot be reproduced; the
  kernel computes the threefry2x32 words of ``random.bits(PRNGKey(seed),
  shape)`` in registers, the contract the R-MAT kernel
  ``rmat_sample_prng`` keeps too;
* ``column_sum`` (S4, ``loop_kernel``): (R, C) → (1, C), each thread
  adding the rows in order, as the ``fori_loop`` does.

Every wrapper checks its inputs; for tensors on the CPU it takes the plain
version in ``kernels/ref.py``, for CUDA tensors it launches the kernel on
torch's current stream or raises.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

import ctypes
import math
from pathlib import Path
from typing import Dict, Sequence

import torch

from repro_torch.kernels import _build, ref

#: launches of each kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"add": 0, "double_blocks": 0, "prng_bits": 0,
                            "column_sum": 0}

SOURCE = Path(__file__).with_name("csrc") / "spike.cu"


def _declare(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.spike_add.argtypes = [p, p, p, ll, p]
    lib.spike_double.argtypes = [p, p, i, i, i, p]
    lib.spike_prng.argtypes = [p, p, ll, p]
    lib.spike_column_sum.argtypes = [p, p, i, i, p]
    for fn in (lib.spike_add, lib.spike_double, lib.spike_prng,
               lib.spike_column_sum):
        fn.restype = i
    lib.spike_error_string.argtypes = [i]
    lib.spike_error_string.restype = ctypes.c_char_p


LIBRARY = _build.CudaLibrary(SOURCE, _declare)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype or t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-d {dtype} "
                         f"tensor, got {t.dtype} {tuple(t.shape)}")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tensor on {t.device}: the kernels take CPU "
                         "tensors (plain version) or CUDA tensors")


def _launch(name: str, fn, out: torch.Tensor, *args) -> torch.Tensor:
    with torch.cuda.device(out.device):
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = LIBRARY.lib().spike_error_string(rc).decode()
        raise RuntimeError(f"{name}: launch failed: {msg} ({rc})")
    LAUNCHES[name] += 1
    return out


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """S1: ``x + y`` of two float32 tensors of one shape."""
    _check("x", x, torch.float32, x.dim())
    _check("y", y, torch.float32, x.dim())
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and y "
                         f"{tuple(y.shape)} on {y.device}: one shape, one "
                         "device")
    if x.device.type == "cpu":
        return ref.add_ref(x, y)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    return _launch("add", LIBRARY.lib().spike_add, out, x.data_ptr(),
                   y.data_ptr(), out.data_ptr(), x.numel())


def double_blocks(x: torch.Tensor, block_rows: int = 128) -> torch.Tensor:
    """S2: ``2 * x`` for a float32 (R, C) tensor, one CTA per block of
    ``block_rows`` rows; R must be a multiple of ``block_rows``."""
    _check("x", x, torch.float32, 2)
    R, C = x.shape
    if block_rows < 1 or R % block_rows:
        raise ValueError(f"R={R} must be a multiple of block_rows="
                         f"{block_rows}")
    if x.device.type == "cpu":
        return ref.double_ref(x)
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    return _launch("double_blocks", LIBRARY.lib().spike_double, out,
                   x.data_ptr(), out.data_ptr(), R // block_rows, block_rows,
                   C)


def prng_bits(seed: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """S3: the int32 patterns of ``random.bits(PRNGKey(seed[0]), shape)``
    for a (1,) int32 ``seed``, on seed's device."""
    _check("seed", seed, torch.int32, 1)
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one int32, got {seed.numel()}")
    shape = tuple(int(s) for s in shape)
    if seed.device.type == "cpu":
        return ref.prng_bits_ref(seed, shape)
    out = torch.empty(shape, dtype=torch.int32, device=seed.device)
    if out.numel() == 0:
        return out
    return _launch("prng_bits", LIBRARY.lib().spike_prng, out,
                   seed.data_ptr(), out.data_ptr(), math.prod(shape))


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """S4: (R, C) float32 → (1, C), the rows added in order 0..R-1."""
    _check("x", x, torch.float32, 2)
    R, C = x.shape
    if x.device.type == "cpu":
        return ref.column_sum_ref(x)
    out = torch.empty((1, C), dtype=torch.float32, device=x.device)
    if C == 0:
        return out
    return _launch("column_sum", LIBRARY.lib().spike_column_sum, out,
                   x.data_ptr(), out.data_ptr(), R, C)
