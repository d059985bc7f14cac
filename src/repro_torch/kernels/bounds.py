"""The H100's published peaks and the least time of each R-MAT kernel's
work, for the benchmarks' bound rows and ``chip_smoke.py``'s kernel line.

Peaks: NVIDIA H100 SXM data sheet and Hopper white paper, dense rates at
the full 700 W power limit.  A card set below it runs slower under load,
so every measurement is written beside the card's power limit.
"""
from __future__ import annotations

#: HBM3 bytes/s; SM clocks/s (132 SMs at the 1.98 GHz boost clock); per SM
#: and clock, 64 lanes of the integer (alu) pipe, the only pipe that runs
#: logic ops, and 64 of the FMA-heavy pipe, which runs integer adds (as
#: IMAD.IADD) and multiplies, so shifts too (IMAD.SHL, IMAD.HI); the four
#: warp schedulers issue one instruction each a clock, 128 lanes in all
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_LANES, FMA_HEAVY_LANES = 64, 64
ISSUE_LANES = 128

#: 32-bit integer operations one level of the in-register kernel (K2)
#: cannot do without, per edge.  threefry2x32 does 21 xors (one a round,
#: one to join its two words), which only the alu pipe runs; 20 rotations,
#: each one alu funnel shift (SHF.L.W) or two FMA-pipe ops (rotl(x, r) =
#: hi(x * 2^r) + x * 2^r: IMAD.SHL, then IMAD.HI adding it; IMAD.WIDE makes
#: both halves in one instruction at half the IMAD rate, the same two
#: lane-clocks of the FMA pipe, and ``pipe_clocks`` counts the two pipes'
#: lanes together against the issue limit); and 27 adds
#: (20 rounds, the five key injections into x1, the last into x0 and x1's
#: first key add; x0's other key adds fold into three-input round adds),
#: each counted as one operation that either pipe runs (a three-input add
#: is one IADD3 on the alu pipe or two IMADs).  The descend's compares and
#: id updates are left out, so the bound stays a lower bound.
PRNG_XORS_PER_LEVEL, PRNG_ROTATIONS_PER_LEVEL, PRNG_ADDS_PER_LEVEL = 21, 20, 27
#: the fewest of them: every rotation one funnel shift
PRNG_INT_OPS_PER_LEVEL = (PRNG_XORS_PER_LEVEL + PRNG_ROTATIONS_PER_LEVEL
                          + PRNG_ADDS_PER_LEVEL)

#: dense peaks: bf16 on the tensor cores and float32 on the FMA pipes
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def pipe_clocks(alu: float, fma: float, either: float = 0.0) -> float:
    """SM clocks for ``alu`` operations that only the alu pipe runs,
    ``fma`` that only the FMA-heavy pipe runs and ``either`` that either
    runs, split at best: the busier pipe's lanes or the issue limit,
    whichever takes longer."""
    return max(alu / ALU_LANES, fma / FMA_HEAVY_LANES,
               (alu + fma + either) / min(ISSUE_LANES,
                                          ALU_LANES + FMA_HEAVY_LANES))


def prng_level_clocks() -> float:
    """Least SM clocks of one edge's threefry work a level: the xors on
    the alu pipe, the adds on either pipe, and the rotations split between
    a funnel shift on the alu pipe and two IMADs on the FMA pipe, at the
    split that takes least time.  The time is convex in the rotations put
    on the FMA pipe, so its least is at 0, all of them, or where two of
    ``pipe_clocks``'s terms meet."""
    x, r, a = (PRNG_XORS_PER_LEVEL, PRNG_ROTATIONS_PER_LEVEL,
               PRNG_ADDS_PER_LEVEL)
    # alu-only x + r - f, FMA-only 2f: equal at f = (x + r) / 3; the alu
    # side against the issue limit at (x + r - a) / 3, the FMA side
    # against it at (x + r + a) / 3
    splits = (0.0, float(r), (x + r) / 3, (x + r - a) / 3, (x + r + a) / 3)
    return min(pipe_clocks(x + r - f, 2 * f, a)
               for f in splits if 0 <= f <= r)


def prng_bound_s(L: int, n_edges: int) -> float:
    """Least time for K2's threefry work (``prng_level_clocks`` for each
    edge and level, spread over every SM)."""
    return L * n_edges * prng_level_clocks() / SM_CLOCKS_PER_S


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
