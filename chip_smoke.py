#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the R-MAT CUDA kernels from ``src/repro_torch/kernels/csrc`` and
drives the port's generation paths on the card:

1. build the kernels; print the card's name and power limit;
2. the threefry random numbers on the card equal the same calls on the
   CPU;
3. each kernel against its plain PyTorch version on the card: ids must
   match exactly (the unchunked scale-64 shape, wide ids, a counter past
   2^32);
4. the slice at full width: the committed fit
   (``src/repro_torch/assets/tabformer_like_fit.npz``) generates at
   ``scale_nodes=64`` (2^18 × 2^15 nodes, 163 840 000 edges, 2 cont +
   3 cat features, aligned) through the auto-selected ``cuda_prng``
   backend, which must launch the in-register kernel; the kernel and the
   run's edges equal the plain version at its largest and smallest chunk;
5. the same fit at scale 1 with ``backend="cuda_bits"`` on the card and
   on the CPU: identical edges, aligned rows equal on ≥ 99% of rows; the
   card's run must launch the bits kernel;
6. the public narrow wrapper ``kernels.ops.rmat_edges``, which must
   launch the uniforms kernel and equal ``ref.rmat_ref``;
7. edge sampling alone at n = m = 27, E = 2^30;
8. a ``kernels`` JSON line: per kernel its launches on its path (phases
   4–6, counters reset before each), max |kernel − plain|, its time, its
   plain version's time and its bound, all at the largest chunk of
   phase 4; for the in-register kernel also the static opcode counts of
   its level loop in the built SASS.

Every phase raises on failure.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"

#: H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bytes/s;
#: SM clocks/s (132 SMs at the 1.98 GHz boost clock); per SM and clock,
#: 64 lanes of the integer (alu) pipe, the only pipe that runs shifts and
#: logic ops, and 64 of the FMA-heavy pipe, which runs integer adds too
#: (as IMAD.IADD)
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
ALU_LANES, FMA_HEAVY_LANES = 64, 64
#: 32-bit integer operations one level of the in-register kernel cannot
#: do without, per edge.  threefry2x32 does 20 rotations (one funnel shift
#: each) and 21 xors (one per round, one to join its two words): 41 that
#: only the alu pipe runs.  Its adds: 20 rounds, the five key injections
#: into x1, the last into x0 and x1's first key add (x0's other key adds
#: fold into three-input round adds): 27, which either pipe runs.  The
#: descend's compares and id updates are left out, so the bound stays a
#: lower bound.  ``sass_level_loop`` reads what the compiler emitted.
PRNG_ALU_OPS_PER_LEVEL = 41
PRNG_INT_OPS_PER_LEVEL = 41 + 27

#: kernel shape of the scale-64 struct drawn unchunked (n=18, m=15), with
#: the demo θ; the main path itself draws 16 chunks of n=16, m=13
MAIN_N, MAIN_M, MAIN_E = 18, 15, 1 << 24
K_PREF = 2                              # generate()'s default chunking
DEMO_THETA = [0.45, 0.22, 0.2, 0.13]    # scripts/generate_dataset.py demo


def prng_bound_s(L: int, n_edges: int) -> float:
    """Least time for K2's threefry work: each pipe's share at its rate,
    the alu pipe alone for shifts and xors, both pipes for all of it."""
    per_lane = max(PRNG_ALU_OPS_PER_LEVEL / ALU_LANES,
                   PRNG_INT_OPS_PER_LEVEL / (ALU_LANES + FMA_HEAVY_LANES))
    return L * n_edges * per_lane / SM_CLOCKS_PER_S


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def max_word_err(got, want) -> int:
    """max |kernel − plain| over the (hi, lo) id words of both ends."""
    import torch
    err = 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            check((x is None) == (y is None), "id word layout differs")
            if x is not None:
                d = (x.to(torch.int64) - y.to(torch.int64)).abs().max()
                err = max(err, int(d))
    return err


def sass_level_loop(sass: str) -> dict:
    """Static opcode counts of the in-register kernel's level loop in
    ``cuobjdump -sass`` text: the innermost backward branch whose range
    holds the threefry rotations (``SHF.L.W``), per threefry copy in it
    (rotations / 20).  Backs the operation counts of its bound."""
    import re
    from collections import Counter
    insts, in_fn = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            in_fn = "rmat_kernelILi2E" in line
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][\w.]*)(.*)", line)
        if in_fn and ins:
            insts.append((int(ins.group(1), 16), ins.group(2),
                          ins.group(3)))
    rot = [a for a, op, _ in insts if op.startswith("SHF.L.W")]
    loops = []
    for a, op, rest in insts:
        tgt = re.match(r"\s*0x([0-9a-f]+)", rest)
        if op == "BRA" and tgt and int(tgt.group(1), 16) < a:
            lo = int(tgt.group(1), 16)
            if any(lo <= r <= a for r in rot):
                loops.append((a - lo, lo, a))
    if not loops:
        return {}
    _, lo, hi = min(loops)
    body = [op for a, op, _ in insts if lo <= a <= hi]
    n_rot = sum(op.startswith("SHF.L.W") for op in body)
    copies = n_rot / 20
    ops = Counter(op.split(".")[0] for op in body)
    return {"threefry_copies": copies,
            "instructions": len(body) / copies,
            "SHF.L.W": n_rot / copies,
            "IMAD.IADD": sum(op == "IMAD.IADD" for op in body) / copies,
            **{op: n / copies for op, n in sorted(ops.items())}}


def read_sass(rs) -> str:
    """``cuobjdump -sass`` of the built library ('' without the tool)."""
    tool = Path(rs._nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return ""
    return subprocess.run([str(tool), "-sass", str(rs.library_path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def phase_rng(tr, torch) -> None:
    key = tr.PRNGKey(20260)
    check(torch.equal(tr.split(key, 1000, "cuda").cpu(), tr.split(key, 1000)),
          "split differs on the card")
    for d in (0, 77, 0x5eed, 2 ** 31 + 9):
        check(torch.equal(tr.fold_in(key, d, "cuda").cpu(),
                          tr.fold_in(key, d)), "fold_in differs on the card")
    shape = (18, 1 << 20)
    check(torch.equal(tr.bits(key, shape, "cuda").cpu(), tr.bits(key, shape)),
          "bits differ on the card")
    check(torch.equal(tr.uniform(key, shape, device="cuda").cpu(),
                      tr.uniform(key, shape)), "uniform differs on the card")
    dn = (tr.normal(key, (1 << 20,), "cuda").cpu()
          - tr.normal(key, (1 << 20,))).abs().max().item()
    dg = (tr.gumbel(key, (1 << 20,), "cuda").cpu()
          - tr.gumbel(key, (1 << 20,))).abs().max().item()
    log(f"rng: split/fold_in/bits/uniform equal on cuda and cpu; "
        f"max |normal| diff {dn:.3g}, max |gumbel| diff {dg:.3g}")
    check(dn <= 1e-5 and dg <= 1e-5, "normal/gumbel drift on the card")


def phase_kernels(tr, ref, rs, torch) -> dict:
    """Each kernel against its plain version; returns max errors."""
    errs = {k: 0 for k in rs.LAUNCHES}

    def thetas(L):
        return torch.tensor([DEMO_THETA] * L, dtype=torch.float32,
                            device="cuda")

    for n, m, E in ((MAIN_N, MAIN_M, MAIN_E), (34, 30, 1 << 22)):
        L = max(n, m)
        th = thetas(L)
        bits = tr.bits(tr.PRNGKey(n), (L, E), "cuda")
        u = ref.bits_to_uniform_ref(bits)
        want = ref.rmat_parts_ref(th, u, n, m)
        e1 = max_word_err(rs.rmat_sample_bits(th, bits, n, m), want)
        e3 = max_word_err(rs.rmat_sample_uniforms(th, u, n, m), want)
        # K2 reads the same words from registers: its ids equal K1's
        e2 = max_word_err(rs.rmat_sample_prng(tr.PRNGKey(n), th, n, m, E, E),
                          want)
        errs["rmat_sample_bits"] = max(errs["rmat_sample_bits"], e1)
        errs["rmat_sample_uniforms"] = max(errs["rmat_sample_uniforms"], e3)
        errs["rmat_sample_prng"] = max(errs["rmat_sample_prng"], e2)
        log(f"kernels n={n} m={m} E={E}: max|err| bits={e1} "
            f"uniforms={e3} prng-vs-bits={e2}")
        del bits, u, want

    # counters past 2^32: L * stride > 2^32, so the hi counter word is live
    n = m = 27
    stride, E = 1 << 28, 1 << 20
    th = thetas(27)
    key = tr.PRNGKey(99)
    cols = torch.arange(E, dtype=torch.int64, device="cuda")
    bits = torch.stack([tr.bits_at(key, cols + ell * stride)
                        for ell in range(27)])
    got = rs.rmat_sample_prng(key, th, n, m, E, stride)
    e_k1 = max_word_err(got, rs.rmat_sample_bits(th, bits, n, m))
    e_plain = max_word_err(got, ref.rmat_prng_ref(key, th, n, m, E, stride))
    log(f"kernels L*stride = {27 * stride} > 2^32: prng-vs-bits={e_k1} "
        f"prng-vs-plain={e_plain}")
    errs["rmat_sample_prng"] = max(errs["rmat_sample_prng"], e_k1, e_plain)
    for k, v in errs.items():
        check(v == 0, f"{k} disagrees with its plain version (max {v})")
    return errs


def phase_main_path(convert, tr, rmat, sampler, ref, rs, gops, torch):
    """``generate(scale_nodes=64, chunked=True)`` of the committed fit on
    the auto backend.  Returns K2's launches in it, K2's max error at the
    shapes it gave K2, and the largest chunk's kernel arguments."""
    import numpy as np
    state = convert.load_state(ASSET)
    pipe = convert.pipeline_from_state(state, device="cuda")
    st = pipe.struct.scaled(64)
    log(f"main path: asset fit n={pipe.struct.n} m={pipe.struct.m} "
        f"E={pipe.struct.E}; scale 64 -> n={st.n} m={st.m} E={st.E}; "
        f"schema {pipe.features.schema}; no size cut")
    torch.cuda.reset_peak_memory_stats()
    rs.reset_launches()
    t0 = time.time()
    g, cont, cat = pipe.generate(seed=0, scale_nodes=64, chunked=True)
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = dict(rs.LAUNCHES)
    tm = pipe.timings
    log(f"main path: gen_struct_s={tm.gen_struct_s:.3f} "
        f"gen_feat_s={tm.gen_feat_s:.3f} gen_align_s={tm.gen_align_s:.3f} "
        f"wall_s={wall:.3f} peak_mem_GB="
        f"{torch.cuda.max_memory_allocated() / 1e9:.2f} launches={launches}")
    check(launches["rmat_sample_prng"] > 0, "main path never ran cuda_prng")
    check(g.n_edges == st.E, f"edge count {g.n_edges} != {st.E}")
    check(int(g.src.min()) >= 0 and int(g.src.max()) < 2 ** st.n,
          "src ids out of range")
    check(int(g.dst.min()) >= 0 and int(g.dst.max()) < 2 ** st.m,
          "dst ids out of range")
    check(tuple(cont.shape) == (st.E, pipe.features.schema.n_cont),
          "cont shape")
    check(tuple(cat.shape) == (st.E, pipe.features.schema.n_cat), "cat shape")
    check(not torch.isnan(cont).any().item(), "NaN features")
    cards = torch.tensor(pipe.features.schema.cat_cards, device="cuda")
    check(bool(((cat >= 0) & (cat < cards)).all()), "category out of range")
    feats = gops.node_features(g)
    bad = (~torch.isfinite(feats)).sum(0).tolist()
    log(f"main path: non-finite node_features entries per column "
        f"[out_deg, in_deg, pagerank, log1p(katz)] = {bad} of "
        f"{feats.shape[0]} nodes (Katz overflows float32 on large hubs, "
        f"as in the reference)")
    del feats

    # K2 at the shapes this run gave it, with the run's own per-level θ
    # (seed 0's θ-noise, the rng's first draw in generate): the largest
    # and the smallest chunk, kernel and the run's edges against plain
    thetas = rmat.derive_thetas(st, rng=np.random.default_rng(0))
    plan = rmat.chunk_plan(st, K_PREF, thetas)
    check(len(plan) == launches["rmat_sample_prng"],
          f"{len(plan)} chunks but {launches['rmat_sample_prng']} launches")
    starts = np.cumsum([0] + [ck.n_edges for ck in plan])
    n_s, m_s = st.n - K_PREF, st.m - K_PREF
    th = torch.tensor(thetas[K_PREF:], dtype=torch.float32, device="cuda")
    sizes = [ck.n_edges for ck in plan]
    err, largest = 0, None
    for i in sorted({int(np.argmax(sizes)), int(np.argmin(sizes))}):
        ck = plan[i]
        key = rmat.chunk_key(tr.PRNGKey(0), ck.index)
        pad = sampler._pad_edges(ck.n_edges,
                                 sampler.choose_block(ck.n_edges))
        want = ref.rmat_prng_ref(key, th, n_s, m_s, ck.n_edges, pad)
        e_kern = max_word_err(
            rs.rmat_sample_prng(key, th, n_s, m_s, ck.n_edges, pad), want)
        rows = slice(int(starts[i]), int(starts[i + 1]))
        e_run = max(
            int((g.src[rows].to(torch.int64) - want[0].lo
                 - (ck.src_prefix << n_s)).abs().max()),
            int((g.dst[rows].to(torch.int64) - want[1].lo
                 - (ck.dst_prefix << m_s)).abs().max()))
        log(f"main path chunk {ck.index}: n={n_s} m={m_s} "
            f"E={ck.n_edges} stride={pad}, per-level θ: max|err| "
            f"prng-vs-plain={e_kern} run-vs-plain={e_run}")
        err = max(err, e_kern, e_run)
        if i == int(np.argmax(sizes)):
            largest = (key, th, n_s, m_s, ck.n_edges, pad)
        del want
    check(err == 0, f"K2 disagrees at the main path's shapes (max {err})")
    del g, cont, cat
    torch.cuda.empty_cache()
    return launches["rmat_sample_prng"], err, largest


def phase_card_vs_cpu(convert, rs, torch):
    """The bits-kernel path: ``generate(backend="cuda_bits")`` on the card
    against the same call on the CPU, whose wrapper takes the plain
    version: equal edges are K1 equal to its plain version at the shape
    and θ this path gives it.  Returns the bits kernel's launches in the
    card's run and that max error."""
    state = convert.load_state(ASSET)
    out = {}
    for dev in ("cuda", "cpu"):
        pipe = convert.pipeline_from_state(state, device=dev)
        rs.reset_launches()
        g, cont, cat = pipe.generate(seed=0, scale_nodes=1,
                                     backend="cuda_bits")
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = rs.LAUNCHES["rmat_sample_bits"]
        out[dev] = (g.src.cpu(), g.dst.cpu(), cont.cpu(), cat.cpu())
    (s1, d1, c1, k1), (s2, d2, c2, k2) = out["cuda"], out["cpu"]
    err = max(int((s1.to(torch.int64) - s2).abs().max()),
              int((d1.to(torch.int64) - d2).abs().max()))
    check(err == 0 and s1.shape == s2.shape,
          "struct ids differ between card and CPU")
    rows = ((k1 == k2).all(1)
            & torch.isclose(c1, c2, rtol=1e-5, atol=1e-5).all(1))
    frac = rows.float().mean().item()
    log(f"card vs cpu (scale 1, cuda_bits): struct identical, aligned rows "
        f"equal on {frac:.4%}, max |cont diff| "
        f"{(c1 - c2).abs().max().item():.3g}, bits-kernel launches "
        f"{launches}")
    check(frac >= 0.99, "aligned rows differ between card and CPU")
    check(launches > 0, "generate(backend='cuda_bits') never ran the bits "
          "kernel")
    return launches, err


def phase_narrow_ops(tr, ops, ref, rs, torch):
    """The uniforms-kernel path: the public narrow wrapper
    ``kernels.ops.rmat_edges`` at the unchunked scale-64 shape, against
    the plain ``ref.rmat_ref`` on the same inputs.  Returns its kernel's
    launches and max error."""
    n, m, E = MAIN_N, MAIN_M, MAIN_E
    th = torch.tensor([DEMO_THETA] * n, dtype=torch.float32, device="cuda")
    u = tr.uniform(tr.PRNGKey(3), (n, E), device="cuda")
    rs.reset_launches()
    s, d = ops.rmat_edges(th, u, n=n, m=m)
    torch.cuda.synchronize()
    launches = rs.LAUNCHES["rmat_sample_uniforms"]
    ws, wd = ref.rmat_ref(th, u, n, m)
    err = max(int((s - ws).abs().max()), int((d - wd).abs().max()))
    check(s.dtype == torch.int32 and err == 0, "rmat_edges ids")
    check(launches > 0, "rmat_edges never ran the uniforms kernel")
    log(f"narrow ops path: rmat_edges n={n} m={m} E={E}, uniforms-kernel "
        f"launches {launches}, max|err| vs rmat_ref {err}")
    return launches, err


def phase_struct_at_scale(tr, rmat, KroneckerFit, rs, torch) -> None:
    fit = KroneckerFit(*DEMO_THETA, n=27, m=27, E=1 << 30)
    key = tr.PRNGKey(0)
    rs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    s, d = rmat.sample_graph_chunked(key, fit, k_pref=2, backend="cuda_prng",
                                     device="cuda")
    torch.cuda.synchronize()
    dt = time.time() - t0
    check(s.numel() == fit.E and int(s.max()) < 2 ** 27
          and int(d.max()) < 2 ** 27, "struct-at-scale ids")
    log(f"struct at scale: n=m=27 E={fit.E} cuda_prng, "
        f"{rs.LAUNCHES['rmat_sample_prng']} launches, {dt:.3f}s, "
        f"{fit.E / dt:.4g} edges/s")
    del s, d
    torch.cuda.empty_cache()


def phase_timing(tr, ref, rs, torch, errs: dict, launches: dict,
                 largest) -> list:
    """Each kernel at the largest chunk the main path drew: K2 on its own
    arguments, K1 and K3 on the words (and uniforms) ``cuda_bits`` would
    draw for that chunk."""
    key, th, n, m, E, pad = largest
    L = max(n, m)
    bits = tr.bits(key, (L, pad), "cuda")
    u = ref.bits_to_uniform_ref(bits)
    read_bound = (4 * L * pad + 2 * 4 * pad) / HBM_BYTES_PER_S
    shape = (f"n={n} m={m} L={L} E={E} stride={pad}: the largest chunk "
             f"of generate(scale_nodes=64), its per-level θ")
    rows = []
    for name, kern, plain, bound_s, by in (
            ("rmat_sample_bits",
             lambda: rs.rmat_sample_bits(th, bits, n, m),
             lambda: ref.rmat_parts_ref(th, ref.bits_to_uniform_ref(bits),
                                        n, m),
             read_bound, "bytes"),
            ("rmat_sample_uniforms",
             lambda: rs.rmat_sample_uniforms(th, u, n, m),
             lambda: ref.rmat_parts_ref(th, u, n, m),
             read_bound, "bytes"),
            ("rmat_sample_prng",
             lambda: rs.rmat_sample_prng(key, th, n, m, E, pad),
             lambda: ref.rmat_prng_ref(key, th, n, m, E, pad),
             max(prng_bound_s(L, E), 2 * 4 * E / HBM_BYTES_PER_S),
             "operations")):
        plain_ms = cuda_ms(plain, 2)
        ms = cuda_ms(kern, 10)
        ms2 = cuda_ms(kern, 10)
        plain_ms2 = cuda_ms(plain, 2)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/rmat_sample.cu",
            "replaces": {"rmat_sample_bits":
                         "src/repro/kernels/rmat_sample.py:132",
                         "rmat_sample_uniforms":
                         "src/repro/kernels/rmat_sample.py:109",
                         "rmat_sample_prng":
                         "src/repro/kernels/rmat_sample.py:154"}[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "bound_ms": bound_s * 1e3, "bound_by": by, "library_ms": None,
            "shape": shape})
        log(f"timing {name}: kernel {ms:.4f}/{ms2:.4f} ms, plain "
            f"{plain_ms:.3f}/{plain_ms2:.3f} ms, bound {bound_s * 1e3:.4f} "
            f"ms ({by}), {shape}")
    log("library_ms: no single PyTorch call computes an R-MAT descend, so "
        "there is no library yardstick")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import convert, random as tr
    from repro_torch.core import rmat, sampler
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.graph import ops as gops
    from repro_torch.kernels import ops, ref, rmat_sample as rs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    t0 = time.time()
    rs.build(verbose=True)
    log(f"build: {time.time() - t0:.2f}s ({rs.library_path().name}); "
        f"card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    sass = sass_level_loop(read_sass(rs))
    log(f"sass: the prng kernel's level loop, static opcodes per threefry "
        f"copy: {sass or 'not read'}; its bound counts "
        f"{PRNG_ALU_OPS_PER_LEVEL} alu-only (SHF + LOP3) and "
        f"{PRNG_INT_OPS_PER_LEVEL} integer operations per level")

    phase_rng(tr, torch)
    errs = phase_kernels(tr, ref, rs, torch)
    # each path runs with the counters at 0 and is read right after; each
    # kernel is also held against its plain version at the shapes its
    # path gave it
    launches = {}
    launches["rmat_sample_prng"], e2, largest = phase_main_path(
        convert, tr, rmat, sampler, ref, rs, gops, torch)
    launches["rmat_sample_bits"], e1 = phase_card_vs_cpu(convert, rs, torch)
    launches["rmat_sample_uniforms"], e3 = phase_narrow_ops(tr, ops, ref, rs,
                                                            torch)
    for name, e in (("rmat_sample_prng", e2), ("rmat_sample_bits", e1),
                    ("rmat_sample_uniforms", e3)):
        errs[name] = max(errs[name], e)
    phase_struct_at_scale(tr, rmat, KroneckerFit, rs, torch)
    rows = phase_timing(tr, ref, rs, torch, errs, launches, largest)
    if sass:
        rows[-1]["sass_level_loop"] = sass

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
