"""Wrappers over the CUDA counterparts of the Pallas toolchain probes.

They replace the four kernels of ``scripts/spike_pallas.py`` one for one,
at that script's shapes:

* ``add`` (S1, ``add_kernel``): float32 ``x + y``;
* ``double_blocks`` (S2, ``blk_kernel``): ``2 * x``; R must be a multiple
  of ``block_rows``, the script's row blocks, which are not the launch
  shape on the card;
* ``prng_bits`` (S3, ``prng_kernel``): random bits from an int32 seed that
  the kernel reads.  The TPU's hardware bits cannot be reproduced; the
  kernel computes the threefry2x32 words of ``random.bits(PRNGKey(seed),
  shape)`` in registers, the contract the R-MAT kernel
  ``rmat_sample_prng`` keeps too;
* ``column_sum`` (S4, ``loop_kernel``): (R, C) → (1, C), each thread
  adding the rows in order, as the ``fori_loop`` does.

S1 and S2 are elementwise kernels with 16-byte accesses
(``csrc/spike_elementwise.cu``), S3 and S4 kernels with 16-byte stores and
loads (``csrc/spike.cu``); all four are bound as the torch ops
``torch.ops.repro_spike.add``, ``double_blocks``, ``prng_bits`` and
``column_sum`` (``csrc/spike_ops.cpp``, one library), which check their
inputs, guard the device, take torch's current stream and allocate in
C++: a CUDA tensor goes straight to the op.

For tensors on the CPU every wrapper checks its inputs and takes the plain
version in ``kernels/ref.py``; for CUDA tensors the op launches the kernel
on torch's current stream or raises.  ``LAUNCHES`` counts the launches.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Sequence

import torch

from repro_torch.kernels import _build, ref

#: launches of each kernel since the last ``reset_launches``
LAUNCHES: Dict[str, int] = {"add": 0, "double_blocks": 0, "prng_bits": 0,
                            "column_sum": 0}

CSRC = Path(__file__).with_name("csrc")
OPS_LIBRARY = _build.TorchOpLibrary(
    (CSRC / "spike_elementwise.cu", CSRC / "spike.cu"),
    CSRC / "spike_ops.cpp")
#: ``torch.ops.repro_spike.{add,double_blocks,prng_bits,column_sum}.default``,
#: once loaded
_ADD = _DOUBLE = _PRNG = _COLUMN_SUM = None


def _load_ops() -> None:
    global _ADD, _DOUBLE, _PRNG, _COLUMN_SUM
    OPS_LIBRARY.load()
    ops = torch.ops.repro_spike
    _ADD, _DOUBLE = ops.add.default, ops.double_blocks.default
    _PRNG, _COLUMN_SUM = ops.prng_bits.default, ops.column_sum.default


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


def _check_blocks(x: torch.Tensor, block_rows: int) -> None:
    """The Pallas grid's contract: whole row blocks (a non-2-d ``x`` is
    refused by the dtype/shape check)."""
    if block_rows < 1 or (x.dim() == 2 and x.shape[0] % block_rows):
        raise ValueError(f"R of x {tuple(x.shape)} must be a multiple of "
                         f"block_rows={block_rows}")


def add(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """S1: ``x + y`` of two float32 tensors of one shape (on the card at
    most 2^30 elements, the kernel's 32-bit indices)."""
    if x.is_cuda:
        if _ADD is None:
            _load_ops()
        out = _ADD(x, y)
        LAUNCHES["add"] += 1
        return out
    _check("x", x, torch.float32, x.dim())
    _check("y", y, torch.float32, x.dim())
    if x.shape != y.shape or x.device != y.device:
        raise ValueError(f"x {tuple(x.shape)} on {x.device} and y "
                         f"{tuple(y.shape)} on {y.device}: one shape, one "
                         "device")
    return ref.add_ref(x, y)


def double_blocks(x: torch.Tensor, block_rows: int = 128) -> torch.Tensor:
    """S2: ``2 * x`` for a float32 (R, C) tensor; R must be a multiple of
    ``block_rows``, the row blocks of the Pallas kernel's grid (on the card
    at most 2^30 elements)."""
    if x.is_cuda:
        _check_blocks(x, block_rows)
        if _DOUBLE is None:
            _load_ops()
        out = _DOUBLE(x)
        LAUNCHES["double_blocks"] += 1
        return out
    _check("x", x, torch.float32, 2)
    _check_blocks(x, block_rows)
    return ref.double_ref(x)


def prng_bits(seed: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """S3: the int32 patterns of ``random.bits(PRNGKey(seed[0]), shape)``
    for a (1,) int32 ``seed``, on seed's device."""
    if seed.is_cuda:
        if _PRNG is None:
            _load_ops()
        out = _PRNG(seed, shape)
        LAUNCHES["prng_bits"] += 1
        return out
    _check("seed", seed, torch.int32, 1)
    if seed.numel() != 1:
        raise ValueError(f"seed must hold one int32, got {seed.numel()}")
    shape = tuple(int(s) for s in shape)
    if min(shape, default=0) < 0:
        raise ValueError(f"shape {list(shape)} has a negative size")
    return ref.prng_bits_ref(seed, shape)


def column_sum(x: torch.Tensor) -> torch.Tensor:
    """S4: (R, C) float32 → (1, C), the rows added in order 0..R-1 (on the
    card at most 2^31 - 1 elements)."""
    if x.is_cuda:
        if _COLUMN_SUM is None:
            _load_ops()
        out = _COLUMN_SUM(x)
        LAUNCHES["column_sum"] += 1
        return out
    _check("x", x, torch.float32, 2)
    return ref.column_sum_ref(x)
