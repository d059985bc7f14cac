"""The fit engine's bit-pair MLE accumulator (paper §3.2.3).

For each level ℓ the pair ``(src_bit_ℓ, dst_bit_ℓ)`` of every observed
edge is an iid draw from ``(a, b, c, d)`` under the Kronecker model, so
the per-level joint counts are the exact MLE of the quadrant
distribution.  :class:`BitPairMLE` counts them on the ids' device with
one ``torch.bincount`` over ``sb * 2 + db`` per level and block; int64
ids are split into the ``(hi, lo)`` int32 words of
``repro_torch.core.descend`` first, so the counts are exact integers for
narrow and wide ids alike, in any chunk order.

The streaming accumulators of the JAX package's engine (degree sketch,
reservoir sample, ``accumulate``, ``fit_structure_streamed``) are not
ported yet.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.descend import LO_BITS

#: rows counted per block: bounds the per-level temporaries
BITPAIR_BLOCK = 1 << 20


def _split_id_words(ids: torch.Tensor
                    ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
    """Split node ids into the engine's (hi, lo) int32 words; ``hi`` is
    None for ids of at most 32 bits (cf. ``descend.combine_ids``, the
    inverse)."""
    if ids.element_size() <= 4:
        return None, ids.to(torch.int32)
    a = ids.to(torch.int64)
    lo = (a & ((1 << LO_BITS) - 1)).to(torch.int32)
    hi = (a >> LO_BITS).to(torch.int32)
    return hi, lo


def _bitpair_counts(s_hi, s_lo, d_hi, d_lo, n: int, m: int) -> torch.Tensor:
    """(hi, lo) id words of one block → (min(n, m), 4) int64 counts of
    ``sb * 2 + db`` per level, level 0 the most significant bit."""

    def bit_at(hi, lo, pos: int):
        if pos >= LO_BITS:
            if hi is None:
                return torch.zeros_like(lo)
            return (hi >> (pos - LO_BITS)) & 1
        return (lo >> pos) & 1

    rows = []
    for ell in range(min(n, m)):
        sb = bit_at(s_hi, s_lo, n - 1 - ell)
        db = bit_at(d_hi, d_lo, m - 1 - ell)
        rows.append(torch.bincount(sb * 2 + db, minlength=4))
    return torch.stack(rows)


class BitPairMLE:
    """One-pass per-level bit-pair counts == per-level quadrant MLE.

    ``counts[ell]`` holds the (a, b, c, d)-order joint counts of
    ``(src_bit_ell, dst_bit_ell)`` over every row seen; ``ratios()`` is
    the level-averaged frequency vector."""

    def __init__(self, n: int, m: int, block: int = BITPAIR_BLOCK):
        self.n, self.m = int(n), int(m)
        self.lv = min(self.n, self.m)
        self.block = int(block)
        self.counts = np.zeros((max(self.lv, 1), 4), np.int64)
        self.rows = 0

    def update(self, src, dst) -> "BitPairMLE":
        """Count a chunk of ids (tensors on any device, or host arrays)."""
        src = torch.as_tensor(src)
        dst = torch.as_tensor(dst, device=src.device)
        if len(src) != len(dst):
            raise ValueError(f"src/dst lengths differ: {len(src)} != "
                             f"{len(dst)}")
        self.rows += len(src)
        if not self.lv or not len(src):
            return self
        for off in range(0, len(src), self.block):
            s_hi, s_lo = _split_id_words(src[off: off + self.block])
            d_hi, d_lo = _split_id_words(dst[off: off + self.block])
            out = _bitpair_counts(s_hi, s_lo, d_hi, d_lo, self.n, self.m)
            self.counts += out.cpu().numpy().astype(np.int64)
        return self

    def ratios(self) -> np.ndarray:
        """Level-averaged (a, b, c, d) frequency — the MLE point."""
        total = self.counts.sum()
        return self.counts.sum(axis=0) / max(total, 1)
