"""Counter-based threefry2x32 random numbers: ``jax.random`` in torch.

The port reproduces the JAX package's random streams bit for bit, so a
seed gives the same edges in both packages.  This module is the part of
``jax.random`` that the generation path uses, in jax's default
*partitionable* threefry mode (``jax_threefry_partitionable=True``):

* ``bits(key, shape)[i] = w0 ^ w1`` where ``(w0, w1) = threefry2x32(key,
  (i >> 32, i & 0xFFFFFFFF))`` and ``i`` is the row-major flat index;
* ``split(key, n)[i] = threefry2x32(key, (0, i))``;
* ``fold_in(key, d) = threefry2x32(key, (0, d))``.

A key is an int64 tensor of shape ``(2,)`` (or ``(n, 2)`` for a batch of
keys from ``split``) holding two uint32 words.  Keys are tiny and always
live on the CPU; the draws (``bits``, ``uniform``, ``normal``,
``gumbel``, ``randint``, ``bernoulli``) run on the ``device`` they are
asked for.  Word
arithmetic is done in int64 tensors masked to 32 bits, because torch has
no full uint32 arithmetic.  ``bits`` returns the uint32 words as their
int32 bit patterns (``np.asarray(t).view(np.uint32)`` recovers them).
"""
from __future__ import annotations

import math
from typing import Sequence, Tuple, Union

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
#: flat elements per threefry pass in ``bits``: bounds the int64
#: temporaries (a dozen of 8 bytes each) to a few GiB at most.  The CPU
#: takes passes of 2^18, whose temporaries stay in cache: 2^23 words take
#: a tenth of the time they take in passes of 2^26
_CHUNK, _CPU_CHUNK = 1 << 26, 1 << 18

Word = Union[int, torch.Tensor]


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK) | (x >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word
                 ) -> Tuple[Word, Word]:
    """The 20-round threefry2x32 block cipher on int64 tensors holding
    uint32 words, or on Python ints.  ``k0``/``k1`` are ints or tensors
    broadcastable to ``x0``/``x1``."""
    k2 = k0 ^ k1 ^ _PARITY
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & MASK
    x1 = (x1 + k1) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` as jax computes it without x64: the
    seed is cut to its low 32 bits, so the key is ``[0, seed mod 2^32]``
    whatever the seed's width."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64)


def key_words(key: torch.Tensor) -> Tuple[int, int]:
    k0, k1 = (int(w) for w in key.reshape(2).tolist())
    return k0, k1


def _counters(key: torch.Tensor, count: torch.Tensor) -> torch.Tensor:
    k0, k1 = key_words(key)
    w0, w1 = threefry2x32(k0, k1, count >> 32, count & MASK)
    return torch.stack([w0, w1], -1)


def split(key: torch.Tensor, num: int = 2, device=None) -> torch.Tensor:
    """``jax.random.split``: ``(num, 2)`` keys (on the CPU unless asked)."""
    return _counters(key, torch.arange(num, dtype=torch.int64,
                                       device=device))


def fold_in(key: torch.Tensor, data: int, device=None) -> torch.Tensor:
    """``jax.random.fold_in`` for a non-negative ``data``, computed on
    Python ints (a few tens of µs, where torch ops took hundreds: the
    chunked samplers fold one key per chunk) and returned on ``device``
    (the CPU unless asked)."""
    k0, k1 = key_words(key)
    w0, w1 = threefry2x32(k0, k1, 0, int(data) & MASK)
    return torch.tensor([w0, w1], dtype=torch.int64, device=device)


def _to_int32(w: torch.Tensor) -> torch.Tensor:
    """uint32 words in int64 → the same bit patterns as int32."""
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def bits(key: torch.Tensor, shape: Sequence[int], device=None
         ) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` as int32 bit patterns."""
    device = torch.device("cpu") if device is None else torch.device(device)
    shape = tuple(int(s) for s in shape)
    total = math.prod(shape)
    out = torch.empty(total, dtype=torch.int32, device=device)
    chunk = _CPU_CHUNK if device.type == "cpu" else _CHUNK
    for lo in range(0, total, chunk):
        hi = min(total, lo + chunk)
        out[lo:hi] = bits_at(key, torch.arange(lo, hi, dtype=torch.int64,
                                               device=device))
    return out.reshape(shape)


def bits_at(key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """The words of ``bits(key, shape)`` at the given int64 flat indices
    (int32 bit patterns, on ``counters``'s device)."""
    k0, k1 = key_words(key)
    w0, w1 = threefry2x32(k0, k1, counters >> 32, counters & MASK)
    return _to_int32(w0 ^ w1)


def bits_to_unit_float(b: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns → float32 in [0, 1) by the mantissa trick:
    ``bitcast((b >>> 9) | 0x3F800000) - 1``."""
    mant = (b.to(torch.int64) & MASK) >> 9
    return (mant | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0, device=None) -> torch.Tensor:
    """``jax.random.uniform`` in float32, with jax's order of operations:
    ``max(minval, f * (maxval - minval) + minval)`` in float32."""
    f = bits_to_unit_float(bits(key, shape, device))
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, f * (hi - lo) + lo)


#: ``np.nextafter(float32(-1), float32(0))``: the low end of jax's normal
_NORMAL_LO = -0.99999994


#: Giles' single-precision erfinv polynomials, the ones XLA lowers
#: ``lax.erf_inv`` to (for ``w < 5`` and ``w >= 5``, highest power first)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv by XLA's polynomial (``torch.erfinv`` differs from
    it by up to ~2e-5 in the tails)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    f32 = dict(dtype=torch.float32, device=x.device)
    c_lt = torch.tensor(_ERFINV_LT5, **f32)
    c_ge = torch.tensor(_ERFINV_GE5, **f32)
    p = torch.where(lt, c_lt[0], c_ge[0])
    for i in range(1, len(_ERFINV_LT5)):
        p = torch.where(lt, c_lt[i], c_ge[i]) + p * w
    out = p * x
    big = torch.finfo(torch.float32).max
    return torch.where(x.abs() == 1, x * big, out)


def normal(key: torch.Tensor, shape: Sequence[int], device=None
           ) -> torch.Tensor:
    """``jax.random.normal`` in float32: ``sqrt(2) * erfinv(u)`` with
    ``u`` uniform on ``[nextafter(-1, 0), 1)``."""
    u = uniform(key, shape, _NORMAL_LO, 1.0, device)
    return erfinv(u) * torch.tensor(math.sqrt(2), dtype=torch.float32,
                                    device=u.device)


#: ``np.finfo(np.float32).tiny``
_TINY = 1.1754943508222875e-38


def gumbel(key: torch.Tensor, shape: Sequence[int], device=None
           ) -> torch.Tensor:
    """``jax.random.gumbel`` (mode "low") in float32:
    ``-log(-log(u))`` with ``u`` uniform on ``[tiny, 1)``."""
    return -torch.log(-torch.log(uniform(key, shape, _TINY, 1.0, device)))


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int, device=None) -> torch.Tensor:
    """``jax.random.randint`` for int32 bounds: two 32-bit draws folded
    into ``[minval, maxval)`` by jax's double-width remainder."""
    k_hi, k_lo = split(key)
    higher = bits(k_hi, shape, device).to(torch.int64) & MASK
    lower = bits(k_lo, shape, device).to(torch.int64) & MASK
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = ((2 ** 16 % span) ** 2 & MASK) % span    # uint32 product wraps
    off = (((higher % span) * mult) & MASK) + (lower % span)
    off = (off & MASK) % span
    return (off + minval).to(torch.int32)


def bernoulli(key: torch.Tensor, p: float, shape: Sequence[int],
              device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)`` (mode "low") for a float
    ``p``: ``uniform(key, shape) < p``, with ``p`` rounded to float32."""
    u = uniform(key, shape, device=device)
    return u < torch.tensor(p, dtype=torch.float32, device=u.device)
