"""The R-MAT level-descend decision core, in torch.

Every edge-sampling path of the port (the ``reference`` backend, the
plain versions in ``kernels/ref.py``) drives this one function; the CUDA
kernels in ``kernels/csrc/rmat_sample.cu`` repeat its arithmetic per
edge and are checked against it.

Wide (>31-bit) node ids keep the JAX package's contract: ids are built
as an ``IdParts(hi, lo)`` pair of int32 words (the first ``bits -
LO_BITS`` levels push into ``hi``, the rest into ``lo``), so kernel
outputs compare word for word with the reference.  ``combine_ids``
reassembles a pair into int64 on the words' own device;
``combine_ids_device`` does the same with a tensor prefix (a mesh step's
device index).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

#: bits held by each int32 word of an ``IdParts`` pair (sign bit excluded)
LO_BITS = 31

#: hard ceiling of the (hi, lo) representation
MAX_ID_BITS = 2 * LO_BITS


class IdParts(NamedTuple):
    """Node ids as a (hi, lo) int32 pair; ``hi is None`` for narrow ids."""
    hi: Optional[torch.Tensor]
    lo: torch.Tensor


def as_torch_dtype(dtype) -> torch.dtype:
    """Accept a torch or numpy integer dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return {np.dtype(np.int32): torch.int32,
            np.dtype(np.int64): torch.int64}[np.dtype(dtype)]


def id_capacity(dtype) -> int:
    """Usable id bits of a signed integer dtype (sign bit excluded)."""
    return torch.iinfo(as_torch_dtype(dtype)).bits - 1


def check_id_capacity(bits: int, dtype, what: str) -> None:
    """Raise a clear error instead of letting prefix/level bit-pushes wrap."""
    cap = id_capacity(dtype)
    name = str(as_torch_dtype(dtype)).replace("torch.", "")
    if bits > MAX_ID_BITS:
        raise ValueError(
            f"{what}: needs {bits} id bits, beyond the {MAX_ID_BITS}-bit "
            "limit of the (hi, lo) int32-pair id representation")
    if bits > cap:
        raise ValueError(
            f"{what}: needs {bits} id bits but id_dtype={name} holds only "
            f"{cap} — pass id_dtype=torch.int64 (ids up to "
            f"{MAX_ID_BITS} bits)")


def default_id_dtype(bits: int) -> torch.dtype:
    """The narrowest supported id dtype for a ``bits``-bit id space."""
    return torch.int32 if bits <= LO_BITS else torch.int64


def descend(get_u: Callable, theta_at: Callable, n: int, m: int,
            zeros: Callable):
    """Shared level loop: one uniform per edge per level, predicated
    bit-pushes.

    ``get_u(ell)`` returns the level's float32 uniforms, ``theta_at(ell)``
    the level's ``(a, b, c)`` float32 scalars, and ``zeros()`` a fresh
    int32 zero accumulator.  Levels beyond ``min(n, m)`` use only the
    marginals (``p = a+b`` row-zero prob, ``q = a+c`` col-zero prob).
    Sums are taken in float32 in the reference's order: ``a + b``, then
    ``(a + b) + c``.  Returns ``(src, dst)`` as ``IdParts``.
    """
    lv_sq = min(n, m)
    n_hi, m_hi = max(0, n - LO_BITS), max(0, m - LO_BITS)
    src_hi = zeros() if n_hi else None
    dst_hi = zeros() if m_hi else None
    src_lo, dst_lo = zeros(), zeros()
    si = di = 0
    for ell in range(max(n, m)):
        u = get_u(ell)
        a, b, c = theta_at(ell)
        sb = db = None
        if ell < lv_sq:
            ab = a + b
            sb = (u >= ab).to(torch.int32)
            db = (((u >= a) & (u < ab)) | (u >= ab + c)).to(torch.int32)
        elif n > m:                   # extra row levels: θ_V = [p; 1-p]
            sb = (u >= a + b).to(torch.int32)
        else:                         # extra col levels: θ_H = [q, 1-q]
            db = (u >= a + c).to(torch.int32)
        if sb is not None:
            if si < n_hi:
                src_hi = src_hi * 2 + sb
            else:
                src_lo = src_lo * 2 + sb
            si += 1
        if db is not None:
            if di < m_hi:
                dst_hi = dst_hi * 2 + db
            else:
                dst_lo = dst_lo * 2 + db
            di += 1
    return IdParts(src_hi, src_lo), IdParts(dst_hi, dst_lo)


def combine_ids(parts: IdParts, bits: int, dtype, prefix: int = 0
                ) -> torch.Tensor:
    """``(prefix << bits) | (hi << LO) | lo`` in ``dtype`` on the words'
    device.  ``bits`` is the number of level bits in ``parts``."""
    dt = as_torch_dtype(dtype)
    out = parts.lo.to(dt)
    if parts.hi is not None:
        out = out + (parts.hi.to(dt) << min(bits, LO_BITS))
    if prefix:
        out = out + (int(prefix) << int(bits))
    return out


def combine_ids_device(parts: IdParts, bits: int, dtype,
                       prefix: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """``combine_ids`` with the prefix a tensor on the words' device (the
    mesh step's device index): ``(prefix << bits) + (hi << LO) + lo``, no
    host round trip."""
    dt = as_torch_dtype(dtype)
    out = parts.lo.to(dt)
    if parts.hi is not None:
        out = out + (parts.hi.to(dt) << min(bits, LO_BITS))
    if prefix is not None:
        out = out + (prefix.to(device=out.device, dtype=dt) << int(bits))
    return out


def narrow_ids(parts: IdParts, n_edges: int, dtype, prefix: int = 0,
               bits: int = 0) -> torch.Tensor:
    """Finalize one narrow (≤ 31-bit) id chunk: trim kernel padding, cast
    to the contract dtype, add the chunk prefix shifted past the ``bits``
    suffix levels."""
    out = parts.lo[:n_edges].to(as_torch_dtype(dtype))
    if prefix:
        out = out + (int(prefix) << int(bits))
    return out
