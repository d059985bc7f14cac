"""Edge sampling for the generalized stochastic Kronecker generator.

All sampling routes through ``repro_torch.core.sampler``.  ``chunk_plan``
+ ``sample_chunk`` implement the paper's App. 10 chunked generation: θ is
split ``θ_pref ⊗ θ_gen``; prefix sampling is replaced by its expectation
``E_i = E · P(prefix = i)``, so chunks are id-disjoint, deterministic in
count, and each needs only its own key (``chunk_key``).

Ids are torch tensors on the requested device: int32 up to 31 bits,
int64 (from the ``(hi, lo)`` word pair) up to 62.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.core import sampler as sampler_mod
from repro_torch.core.descend import as_torch_dtype, check_id_capacity
from repro_torch.core.structure import KroneckerFit, noisy_thetas


def sample_edges(key, thetas, n: int, m: int, n_edges: int,
                 dtype=torch.int32, backend: Optional[str] = None,
                 device="cuda"):
    """Sample ``n_edges`` edges of a 2^n × 2^m adjacency.

    ``backend=None`` keeps the ``reference`` stream (the JAX ``xla``
    stream); pass a registry name or ``'auto'`` to switch engines."""
    be = sampler_mod.get_backend("reference") if backend is None \
        else sampler_mod.resolve_backend(backend, n_edges, device)
    return be.sample(key, thetas, n, m, n_edges, id_dtype=dtype,
                     device=device)


_NOISE_SALT = 0x5eed


def _noise_rng_from_key(key) -> np.random.Generator:
    """The numpy Generator that the JAX package derives from a key."""
    k = trandom.fold_in(key, _NOISE_SALT)
    seed = int(trandom.randint(k, (), 0, np.iinfo(np.int32).max))
    return np.random.default_rng(seed)


def derive_thetas(fit: KroneckerFit,
                  rng: Optional[np.random.Generator] = None,
                  key=None) -> np.ndarray:
    """Canonical (levels, 4) θ derivation — the one place θ-noise is
    drawn.  Without noise the tiled base is returned and no random state
    is used; with noise the draw comes from ``rng`` (or a Generator
    derived from ``key``)."""
    if fit.noise <= 0:
        return np.tile(np.array([fit.a, fit.b, fit.c, fit.d]),
                       (max(fit.n, fit.m), 1))
    if rng is None:
        if key is None:
            raise ValueError("fit.noise > 0: pass rng= or key= so θ-noise "
                             "is derived explicitly (no hidden default rng)")
        rng = _noise_rng_from_key(key)
    return noisy_thetas(fit, rng)


def chunk_key(key, chunk_index: int):
    """Index-stable per-chunk key: depends only on (key, chunk.index)."""
    return trandom.fold_in(key, chunk_index)


def sample_graph(key, fit: KroneckerFit, n_edges: Optional[int] = None,
                 rng: Optional[np.random.Generator] = None,
                 dtype=torch.int32, backend: Optional[str] = None,
                 device="cuda"):
    """One-shot (unchunked) generation from a fit."""
    thetas = derive_thetas(fit, rng=rng, key=key)
    E = n_edges if n_edges is not None else fit.E
    return sample_edges(key, thetas, fit.n, fit.m, E, dtype, backend,
                        device)


class Chunk(NamedTuple):
    src_prefix: int
    dst_prefix: int
    n_edges: int
    index: int


def chunk_plan(fit: KroneckerFit, k_pref: int,
               thetas: Optional[np.ndarray] = None) -> List[Chunk]:
    """The 4^k_pref prefix chunks with expected edge counts (rounded by
    largest remainder so they sum to E); empty chunks are dropped."""
    assert k_pref <= min(fit.n, fit.m), (k_pref, fit.n, fit.m)
    if thetas is None:
        thetas = np.tile(np.array([fit.a, fit.b, fit.c, fit.d]),
                         (max(fit.n, fit.m), 1))
    probs = np.ones(1)
    for ell in range(k_pref):
        probs = np.kron(probs, thetas[ell])
    raw = probs * fit.E
    base = np.floor(raw).astype(np.int64)
    rem = fit.E - base.sum()
    order = np.argsort(raw - base)[::-1]
    base[order[:rem]] += 1
    # de-interleave the 2k_pref-bit chunk index into src (odd) and dst
    # (even) prefix bits
    nz = np.flatnonzero(base)
    sp = np.zeros(len(nz), np.int64)
    dp = np.zeros(len(nz), np.int64)
    for ell in range(k_pref):
        quad = (nz >> (2 * (k_pref - 1 - ell))) & 3
        sp = sp * 2 + (quad >> 1)
        dp = dp * 2 + (quad & 1)
    return [Chunk(int(s), int(d), int(e), int(i))
            for s, d, e, i in zip(sp, dp, base[nz], nz)]


def sample_chunk(key, fit: KroneckerFit, chunk: Chunk, k_pref: int,
                 thetas=None, dtype=torch.int32,
                 backend: Optional[str] = None, device="cuda"):
    """One chunk: suffix levels from θ_gen, prefix bits prepended.
    ``thetas`` is derived once by the caller (``derive_thetas``)."""
    check_id_capacity(fit.n, dtype, "sample_chunk: src prefix+level bits")
    check_id_capacity(fit.m, dtype, "sample_chunk: dst prefix+level bits")
    if thetas is None:
        if fit.noise > 0:
            raise ValueError(
                "fit.noise > 0: derive θ once with derive_thetas() in the "
                "caller and pass thetas= — a per-call default rng would "
                "silently reuse identical θ-noise across chunks")
        thetas = derive_thetas(fit)
    suffix = np.asarray(thetas)[k_pref:]
    n_s, m_s = fit.n - k_pref, fit.m - k_pref
    src, dst = sample_edges(key, suffix, n_s, m_s, chunk.n_edges, dtype,
                            backend, device)
    return src + (chunk.src_prefix << n_s), dst + (chunk.dst_prefix << m_s)


def sample_graph_chunked(key, fit: KroneckerFit, k_pref: int = 2,
                         rng: Optional[np.random.Generator] = None,
                         thetas: Optional[np.ndarray] = None,
                         dtype=torch.int32, backend: Optional[str] = None,
                         device="cuda"):
    """Full graph by chunk concatenation.  θ-noise is derived once and
    threaded through every chunk; ``backend='auto'`` is resolved once for
    the whole plan, so all chunks run on one engine."""
    if thetas is None:
        thetas = derive_thetas(fit, rng=rng, key=key)
    if backend is not None:
        backend = sampler_mod.resolve_backend(backend, fit.E, device).name
    dt = as_torch_dtype(dtype)
    srcs, dsts = [], []
    for ck in chunk_plan(fit, k_pref, thetas):
        s, d = sample_chunk(chunk_key(key, ck.index), fit, ck, k_pref,
                            thetas, dt, backend, device)
        srcs.append(s)
        dsts.append(d)
    return torch.cat(srcs), torch.cat(dsts)


# ---------------------------------------------------------------------------
# Erdős–Rényi baseline (paper §4.1 'random')
# ---------------------------------------------------------------------------

def sample_erdos_renyi(key, n_src: int, n_dst: int, n_edges: int,
                       device="cuda"):
    """``n_edges`` uniform int32 edges on ``device``: ``k1, k2 =
    split(key)``, then ``randint(k1, (n_edges,), 0, n_src)`` and
    ``randint(k2, ..., n_dst)`` — the JAX package's draws (its default
    int32) bit for bit, for any bounds up to 2^31 − 1."""
    k1, k2 = trandom.split(key)
    return (trandom.randint(k1, (n_edges,), 0, n_src, device),
            trandom.randint(k2, (n_edges,), 0, n_dst, device))
