"""Public wrappers over the kernels.

The R-MAT wrappers keep the JAX package's historical contract: ``(src,
dst)`` int32 ids of at most 31 bits.  Wide ids and device/size
auto-selection live one layer up, in ``repro_torch.core.sampler``.  The
Pallas ``block`` and ``interpret`` arguments have no counterpart: the CUDA
kernels take any edge count, and a CPU tensor selects the plain version.
``attention`` is the flash-attention kernel's entry point.
"""
from __future__ import annotations

import torch

from repro_torch import random as trandom
from repro_torch.core.descend import LO_BITS
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import rmat_sample as rs


def _narrow(parts_pair):
    src, dst = parts_pair
    return src.lo, dst.lo


def _require_narrow(n: int, m: int) -> None:
    # raise, not assert: python -O would drop an assert and silently lose
    # the hi id words
    if n > LO_BITS or m > LO_BITS:
        raise ValueError(f"ids need {max(n, m)} bits — wide ids go "
                         "through repro_torch.core.sampler "
                         "(id_dtype=torch.int64)")


def rmat_edges(thetas: torch.Tensor, uniforms: torch.Tensor, *, n: int,
               m: int):
    _require_narrow(n, m)
    return _narrow(rs.rmat_sample_uniforms(thetas, uniforms, n, m))


def rmat_edges_bits(thetas: torch.Tensor, bits: torch.Tensor, *, n: int,
                    m: int):
    _require_narrow(n, m)
    return _narrow(rs.rmat_sample_bits(thetas, bits, n, m))


def rmat_edges_from_key(key: torch.Tensor, thetas: torch.Tensor, *, n: int,
                        m: int, n_edges: int):
    """Threefry bits on ``thetas``'s device → the bits kernel."""
    _require_narrow(n, m)
    bits = trandom.bits(key, (max(n, m), n_edges), thetas.device)
    return rmat_edges_bits(thetas, bits, n=n, m=m)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, blk_q: int = 128, blk_k: int = 128,
              group: int = 1) -> torch.Tensor:
    """Flash attention: q (Hq, S, d), k/v (Hkv, T, d), Hq == Hkv·group."""
    return fa.flash_attention(q, k, v, causal=causal, blk_q=blk_q,
                              blk_k=blk_k, group=group)
