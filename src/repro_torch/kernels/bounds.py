"""The H100's published peaks and the least time of each R-MAT kernel's
work, for the benchmarks' bound rows and ``chip_smoke.py``'s kernel line.

Peaks: NVIDIA H100 SXM data sheet and Hopper white paper, dense rates at
the full 700 W power limit.  A card set below it runs slower under load,
so every measurement is written beside the card's power limit.
"""
from __future__ import annotations

#: HBM3 bytes/s; SM clocks/s (132 SMs at the 1.98 GHz boost clock); per SM
#: and clock, 64 lanes of the integer (alu) pipe, the only pipe that runs
#: shifts and logic ops, and 64 of the FMA-heavy pipe, which runs integer
#: adds too (as IMAD.IADD)
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_LANES, FMA_HEAVY_LANES = 64, 64

#: 32-bit integer operations one level of the in-register kernel (K2)
#: cannot do without, per edge.  threefry2x32 does 20 rotations (one
#: funnel shift each) and 21 xors (one per round, one to join its two
#: words): 41 that only the alu pipe runs.  Its adds: 20 rounds, the five
#: key injections into x1, the last into x0 and x1's first key add (x0's
#: other key adds fold into three-input round adds): 27, which either pipe
#: runs.  The descend's compares and id updates are left out, so the bound
#: stays a lower bound.
PRNG_ALU_OPS_PER_LEVEL = 41
PRNG_INT_OPS_PER_LEVEL = 41 + 27

#: dense peaks: bf16 on the tensor cores and float32 on the FMA pipes
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def prng_bound_s(L: int, n_edges: int) -> float:
    """Least time for K2's threefry work: each pipe's share at its rate,
    the alu pipe alone for shifts and xors, both pipes for all of it."""
    per_lane = max(PRNG_ALU_OPS_PER_LEVEL / ALU_LANES,
                   PRNG_INT_OPS_PER_LEVEL / (ALU_LANES + FMA_HEAVY_LANES))
    return L * n_edges * per_lane / SM_CLOCKS_PER_S


def prng_kernel_bound_s(L: int, n_edges: int) -> float:
    """K2 over ``n_edges`` edges of ``L`` levels: its threefry operations
    against writing two int32 ids an edge, whichever takes longer."""
    return max(prng_bound_s(L, n_edges), 2 * 4 * n_edges / HBM_BYTES_PER_S)


def bits_bound_s(L: int, n_edges: int) -> float:
    """K1 over ``n_edges`` edges: reading ``L`` uint32 words and writing
    two int32 ids an edge, ``4L + 8`` bytes, over HBM."""
    return (4 * L + 8) * n_edges / HBM_BYTES_PER_S


def flash_bound_s(hq: int, hkv: int, s: int, t: int, d: int, causal: bool,
                  dtype: str) -> tuple:
    """Least time for flash attention's work and its limiter: useful
    FLOP (QKᵀ and PV, 2 each per multiply-add; causal counts the
    S(S+1)/2 unmasked pairs) over the type's peak, against q + o + k + v
    bytes over HBM.  At the scoring path's bf16 shape: 6.9e10 FLOP →
    0.070 ms against 75.5 MB → 0.023 ms, so operations bound it."""
    pairs = s * (s + 1) // 2 if causal else s * t
    flops = 4 * hq * d * pairs
    nbytes = (2 * hq * s * d + 2 * hkv * t * d) * (2 if dtype == "bfloat16"
                                                   else 4)
    by_ops, by_bytes = flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S
    return (by_ops, "operations") if by_ops >= by_bytes else (by_bytes,
                                                              "bytes")
