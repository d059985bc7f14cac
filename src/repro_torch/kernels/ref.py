"""Plain PyTorch versions of the CUDA kernels.

Each kernel of ``kernels/rmat_sample.py``, ``kernels/flash_attention.py``
and ``kernels/spike.py`` has its plain version in this module: the
wrappers take it for tensors on the CPU, and ``chip_smoke.py`` holds the
CUDA kernels against it on the card.  The R-MAT ones drive the one
descend core (``repro_torch.core.descend.descend``) with plain tensor
indexing.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch import random as trandom
from repro_torch.core.descend import (LO_BITS, IdParts, check_id_capacity,
                                      combine_ids, descend)


def rmat_parts_ref(thetas: torch.Tensor, uniforms: torch.Tensor, n: int,
                   m: int) -> Tuple[IdParts, IdParts]:
    """The descend over a ``(L, E)`` float32 uniform array: the 2–4 int32
    id words, as the kernels write them."""
    E = uniforms.shape[1]
    th = thetas.to(torch.float32)
    return descend(lambda ell: uniforms[ell],
                   lambda ell: (th[ell, 0], th[ell, 1], th[ell, 2]),
                   n, m,
                   lambda: torch.zeros(E, dtype=torch.int32,
                                       device=uniforms.device))


def bits_to_uniform_ref(bits: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → float32 uniforms by the mantissa trick."""
    return trandom.bits_to_unit_float(bits)


def rmat_prng_ref(key: torch.Tensor, thetas: torch.Tensor, n: int, m: int,
                  n_edges: int, stride: int) -> Tuple[IdParts, IdParts]:
    """Plain version of the in-register-threefry kernel: the first
    ``n_edges`` columns of the descend over ``bits(key, (L, stride))``,
    drawing only the words those columns read (level ``ell`` reads flat
    indices ``ell * stride + e``)."""
    dev = thetas.device
    th = thetas.to(torch.float32)
    cols = torch.arange(n_edges, dtype=torch.int64, device=dev)
    return descend(
        lambda ell: bits_to_uniform_ref(
            trandom.bits_at(key, cols + ell * stride)),
        lambda ell: (th[ell, 0], th[ell, 1], th[ell, 2]),
        n, m, lambda: torch.zeros(n_edges, dtype=torch.int32, device=dev))


def rmat_ref(thetas, uniforms, n: int, m: int, id_dtype=torch.int32):
    """Ids from uniforms: int32 for narrow ids; when ``n``/``m`` exceed 31
    bits the (hi, lo) words are combined into ``id_dtype`` (pass
    ``torch.int64``)."""
    src, dst = rmat_parts_ref(thetas, uniforms, n, m)
    if n <= LO_BITS and m <= LO_BITS:
        return src.lo.to(id_dtype), dst.lo.to(id_dtype)
    check_id_capacity(n, id_dtype, "rmat_ref (src levels)")
    check_id_capacity(m, id_dtype, "rmat_ref (dst levels)")
    return combine_ids(src, n, id_dtype), combine_ids(dst, m, id_dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, group: int = 1) -> torch.Tensor:
    """Plain version of ``flash_attention``: q (Hq, S, d), k/v (Hkv, T, d)
    → (Hq, S, d) in q's dtype, scores scaled by 1/sqrt(d).  Query head
    ``h`` reads kv head ``h // (Hq // Hkv)`` (``repeat_interleave``); the
    full (S, T) scores are made in float32.  ``group`` is implied by the
    shapes, as in the reference."""
    Hq, S, d = q.shape
    Hkv, T, _ = k.shape
    scale = 1.0 / d ** 0.5
    kk = k.repeat_interleave(Hq // Hkv, dim=0)
    vv = v.repeat_interleave(Hq // Hkv, dim=0)
    s = torch.einsum("hsd,htd->hst", q.float(), kk.float()) * scale
    if causal:
        keep = torch.ones((S, T), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("hst,htd->hsd", p, vv.float()).to(q.dtype)


def add_ref(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of the S1 probe ``spike.add``."""
    return x + y


def double_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the S2 probe ``spike.double_blocks``."""
    return 2 * x


def prng_bits_ref(seed: torch.Tensor, shape) -> torch.Tensor:
    """Plain version of the S3 probe ``spike.prng_bits``: the int32
    patterns of ``random.bits(PRNGKey(seed[0]), shape)`` on seed's
    device."""
    return trandom.bits(trandom.PRNGKey(int(seed[0])), tuple(shape),
                        seed.device)


def column_sum_ref(x: torch.Tensor) -> torch.Tensor:
    """Plain version of the S4 probe ``spike.column_sum``: (R, C) → (1, C),
    the rows added in order 0..R-1, as the Pallas ``fori_loop`` adds them."""
    acc = torch.zeros(x.shape[1], dtype=x.dtype, device=x.device)
    for i in range(x.shape[0]):
        acc = acc + x[i]
    return acc[None]
