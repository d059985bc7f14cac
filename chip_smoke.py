#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

    python3 chip_smoke.py

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (one
``nvcc`` per library, all at once) and drives the port's paths on the card:
graph generation (phases 2-7), fitting (phase 4b), writing datasets to
disk (phase 13) and across worker processes (phase 17), scoring what it
generates (phase 14), the paper's baselines (phase 15), the paper's
benchmark tables (phase 16), the dense
LM's scoring forward and serving engine (phases 8-10), training it
(phase 18), the other LM families (phase 19), training them (phase 20),
the production mesh planned without a card (phase 21) and the toolchain
probes S1-S4 (phase 12):

1. build the kernels; print the card's name and power limit; read the
   built SASS and ``-Xptxas -v``: the in-register R-MAT kernel's
   registers and spills per template instance and the opcodes of the
   main path's instance's two level loops per edge and level, and its
   one-edge twin's (the run fails if the main square loop's alu, FMA and
   issue counts would take fewer clocks than its bound, or the instance
   holds no 16-byte store), and the
   ``HGMMA``/``UTMALDG``/``SYNCS`` opcodes of the tensor-core flash kernel
   (the run fails without ``HGMMA``);
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
4b. the fit path at the asset's own settings: ``tabformer_like()``
    (4096 × 512 bipartite, 40 000 edges, 2 cont + 3 cat columns) through
    ``SyntheticGraphPipeline(noise=0.03, gan_steps=200)`` on the card,
    default GBDT: the ``KroneckerFit``, schema and VGMs equal the asset's
    exactly; every GAN loss finite; the port's and the asset's generators
    each draw 40 000 rows (seed 0) that agree per column within the bounds
    of ``GAN_*`` and meet the real table within those of ``REAL_*``;
    ``col_quality`` within ``COL_QUALITY_TOL`` of the asset's; the state
    round trip keeps edges and GBDT scores; the round-tripped aligner's
    ``predict_rows`` (one packed scan over every forest) on the card
    equals its host ``predict_np`` trees on ``PREDICT_ROWS`` rows (cont
    columns within ``PREDICT_TOL``, each categorical column's class the
    host's best score within it); ``generate(seed=0,
    scale_nodes=4, chunked=True)`` from the port's fit launches K2 (counters
    reset before), its edges equal the asset pipeline's, and K2 and the
    run's edges equal the plain version on every chunk; the fit's stage
    times; a ``torch.profiler`` trace of 4 GAN training steps (steps 3-6
    of a fresh fit, its init untraced); the same fit stopped at
    ``GAN_CONTROL_STEPS`` must miss the GAN bounds;
5. the same fit at scale 1 with ``backend="cuda_bits"`` on the card and
   on the CPU: identical edges, aligned rows equal on ≥ 99% of rows; the
   card's run must launch the bits kernel;
6. the public narrow wrapper ``kernels.ops.rmat_edges``, which must
   launch the uniforms kernel and equal ``ref.rmat_ref``;
7. edge sampling alone at n = m = 27, E = 2^30;
8. flash attention against its plain version, each call on the route
   ``flash_attention.route`` gives it: the tensor-core (wgmma) kernel in
   bf16 (< 2e-2) at the scoring path's shape (Hq = 4·32, Hkv = 16, S = T
   = 2048, d = 64, causal), at d = 128, non-causal, GQA group 16 (d 64
   and 128) and a ragged S = T = 1000; the FMA kernel in f32 (< 2e-5,
   TF32 off) at the path's shape and in bf16 at d = 32; then the
   tensor-core kernel on early causal rows of outputs ≥ 4 (V scaled by
   8; Hq 16, Hkv 4, S = T 256 and 2048, d 64 and 128): within one bf16
   step of the plain version on float32 copies where |out| ≥ 4, within
   2e-2 × 8 elsewhere, SDPA's reading logged beside it;
9. scoring at full width: ``tinyllama-1.1b`` (22 layers, bf16, weights
   from ``init_params(PRNGKey(0))``), ``attn_impl="flash"``, B = 4 × S =
   2048 tokens from seed 1: one ``Model.forward``, its loss as
   ``lm_loss`` takes it, both finite, exactly 22 launches of the
   tensor-core kernel; the kernel against its plain version on the first
   layer's own q/k/v; the same forward on the einsum path: loss within
   2e-2;
10. serving at full width: ``ServingEngine(max_batch=4, max_len=512)``,
    8 requests of 16–256 prompt tokens from seed 2, ``max_new=32``: every
    request answered, each first token equal to ``Model.prefill`` of its
    prompt alone into a fresh cache, no flash launch (the engine's cache
    path is the einsum path); decode tokens/s and peak memory;
11. a ``kernels`` JSON line: per kernel its launches on its path (counters
    reset before each), max |kernel − plain|, its time, its plain
    version's time, its bound and, where one PyTorch call computes the
    same function, that call's time: the R-MAT kernels at the largest
    chunk of phase 4 (for the in-register kernel also its registers, the
    static opcode counts of its level loops in the built SASS, and its
    ``shapes``: that chunk, phase 21(e)'s n = m = 30 and Fig. 8's L = 24,
    both at 2^24 edges, phase 13(a)'s mean chunk and both sides of the
    switch from one to eight edges a thread, each equal to its plain
    version and timed beside its bound, device µs and plain version; no
    reading may beat its bound), flash attention at
    phase 8's bf16 shape beside the FMA kernel at the same shape and
    ``scaled_dot_product_attention``, and the probes of phase 12;
12. the probes S1-S4 of ``scripts/spike_pallas.py`` at its shapes and on
    its inputs, one launch each with the counters at 0, each through its
    torch op (``torch.ops.repro_spike.*``, whose library must be loaded,
    and whose kernel the profiler must see), then on random inputs of the
    same shapes: each equal to its plain version bit for bit, timed per
    call in loops of 200 beside ``torch.add``, ``torch.mul`` and
    ``sum(0)``, five rounds of kernel then library, the least of each (S3
    has no library call: ``torch.randint`` is Philox, not threefry; its
    time is set beside S1's op), and each one's device time per call,
    kernel and library, from ``torch.profiler``'s kernel events over such
    a loop; then S3 at 2^26 words and S4 at (64, 2^20), bit-equal, timed
    beside their bounds (and ``sum(0)``) as ``large_*`` fields;
13. datastream (run after phase 7): ``DatasetJob`` writes the committed
    fit to disk on the card. (a) Struct only at ``scale_nodes=64``
    (163 840 000 int32 edges, 1.31 GB, shards of 2^24, ``pipeline_depth=2``,
    the auto backend): K2 must launch once per chunk with its counter
    reset first, ``verify(deep=True)`` must find nothing, the shards in
    order must equal ``sample_graph_chunked`` of the job's key, k_pref and
    θ on the card, and K2 its plain version on the largest chunk; the
    run's stage times, edges/s to disk and bytes on disk are logged, and
    K2's row of the ``kernels`` line carries its ``streamed_launches``.
    (b) Struct only at ``scale_nodes=4``: the card's dataset through
    ``cuda_prng`` equals the CPU's through ``cuda_bits``'s plain version,
    files and manifest. (c) GAN features and the GBDT aligner at
    ``scale_nodes=16`` (10 240 000 edges, shards of 2^21): serial,
    pipelined (depth 2, 2 host workers), pipelined and fused, and
    ``python -m repro_torch.scripts.generate_dataset`` SIGKILLed once its
    journal holds a record and then ``--resume``d with ``--trace`` (its
    event log kept for phase 16), all byte-identical;
    each run's stage busy seconds, overlap, stall and edges/s logged.
    (d) Refit (``phase_refit``): ``python -m
    repro_torch.scripts.fit_dataset --check-theta 0.07`` over (a)'s
    dataset (158 chunks of at most 2^20 rows), its fit JSON equal to
    ``tests/fixtures/refit64.json`` (the JAX package's bytes from the same
    stats), its MLE within 0.02 of the θ the shards were drawn with, its
    exit code its θ check's outcome (logged; ROADMAP C8), its fit JSON
    equal to the same fit with the shards streamed in reverse, whose
    uncalibrated (MLE + Eq. 6) θ must lie within 0.07 of the generator's;
    (b)'s dataset fitted on the card and on the CPU, the fit JSONs equal;
    ``fit_streamed`` of one ``accumulate`` pass over (c)'s serial
    dataset at the asset's settings, but ``REFIT_GBDT_ROUNDS`` (10)
    aligner rounds, on ``REFIT_SAMPLE_ROWS`` (40 000) sample rows (its
    cardinalities the dataset's, GAN losses finite, its draw within the
    ``REAL_*`` bounds of the sample), then ``generate(seed=0,
    scale_nodes=1, chunked=True)`` from it: K2 must
    launch (counter reset first) and equal the plain stream on every
    chunk, folded into K2's row as
    ``refit_path_launches``/``refit_path_max_abs_err``.  It works in a
    temporary directory that it removes.
14. fidelity (run inside and right after phase 4): (a) Table 2's four
    scores of phase 4's own x64 output against ``tabformer_like()``, each
    timed alone, then ``evaluate_all``, equal to them; finite and in
    range; (b) every statistic of ``graph.ops`` on that x64 graph on the
    card (hop plot and effective diameter at 32 sources, 16 hops, seed 0;
    the deduplicated undirected edges and the triangle candidates
    checked), each timed, with the peak device memory; the graph is
    bipartite, so its triangle count must be 0; (c) the asset at
    ``scale_nodes=4`` (640 000 edges): ``evaluate_all`` and every
    statistic on the card equal to the CPU's on the same tensors
    (integers, the hop plot and the effective diameter exactly, floats
    within ``FID_REL``); (d) Table 10: ``cora_like(n=2048,
    n_edges=8000)``, its ``fit_structure`` at noise 0.0 and 0.05 and the
    R-MAT default, each sampled through K2 (``sample_graph(PRNGKey(0))``,
    held against the plain stream), statistics card = CPU; the noise-0.05
    fit at ``scale_nodes=64`` (2^17 nodes, 17 506 304 edges), timed, with
    triangles; there the triangle count and the hop plot, the statistics
    that run in batches, are run again on the card in batches of
    ``FID_SMALL_BATCH`` and must be equal, and the wedges and the largest
    component must equal the CPU's on the same tensors; (e) GCN and GAT
    epochs (Table 4) on ``paysim_like(n=2048, n_edges=8000)`` and its
    Kronecker fit sampled through K2 at scales 1 and 16 (Table 4's
    relative timing for the scale-1 fit only, the graph of the original's
    size), and a 50-epoch GCN on ``cora_like()`` by
    ``train_node_classifier`` on the card and on the CPU, both from
    ``init_gnn(PRNGKey(0))`` (its weights on the two within
    ``GNN_INIT_TOL``): final losses within ``GNN_LOSS_TOL``, test
    accuracies within ``GNN_ACC_TOL``.  K2's launches on (c)-(e) (counter
    reset before each sampling call) and its error against the plain
    stream are K2's ``fidelity_path_*`` fields; the phase's wall is logged
    beside its ``FID_BUDGET_S``.  Phase 4's log line counts the ×64
    graph's non-finite ``log1p(katz)`` entries beside the size of its
    largest connected component (14(b)): Katz overflows float32 across
    the giant component, as in the reference.
15. baselines (run after phase 4b, on the asset pipeline and 4b's fit):
    (a) Table 6's grid as ``benchmarks/table6_ablation.py`` composes it
    (the asset's kronecker structure, GAN and GBDT aligner; SBM, ER, KDE
    and random fitted on ``tabformer_like()``; the random aligner), all
    18 combinations generated at ×4 (640 000 edges) by
    ``SyntheticGraphPipeline.fitted(...).generate`` and scored by
    ``evaluate_all``; the six with neither the GAN nor the GBDT aligner
    equal byte for byte on the CPU, the six GBDT-aligned KDE and random
    ones at ``BASE_GBDT_CPU_SCALE`` equal on ≥ 99% of aligned rows; K2
    against its plain stream on the kronecker rows; (b) Table 2's
    ``random`` (ER + random + random, fitted on the card), ``graphworld``
    (SBM + 4b's GAN + random aligner, SBM's host and card seconds) and
    ``ours`` (the asset) at ×4, stage times and ``evaluate_all``; (c)
    ``ERGenerator`` at ×64 (163 840 000 edges) and
    ``sample_erdos_renyi`` on 2^20 × 2^20 nodes at Table 8's 2^20, 2^23
    and 2^25 edges, warm, edges/s, equal to the CPU's at 2^20; (d) a KDE
    + random-aligner dataset at ×4 by ``DatasetJob`` (3 shards), card =
    CPU file for file, its manifest's ``features`` only ``n_cont`` and
    ``cat_cards``, a deleted shard resumed to the same bytes.  K2's
    launches on (a)-(b) and its error are its ``baselines_path_*``
    fields; the phase's wall is logged beside ``BASE_BUDGET_S``.
16. benchmarks (run after phase 13): the tables of
    ``python -m repro_torch.benchmarks.run`` at their fast sizes, each
    through the runner's ``run_table``, but Table 2, 5 and 6
    (``BENCH_SKIP``: phases 4, 14 and 15 drive their paths),
    ``cluster_scaling`` (phase 17(f) runs it) and ``roofline`` (phase 21
    makes its tables from its own dry-run cells); every
    table's row names (``BENCH_ROWS``) or result keys (``BENCH_KEYS``) and
    finite numbers; Fig. 8 times ``reference``, ``cuda_bits`` (K1) and
    ``cuda_prng`` (K2), each at most its H100 bound, and their ids for
    Fig. 8's key and sizes equal the plain version of the stream on the
    CPU; every ``BENCH_*.json`` names the card and its power limit;
    ``report_run`` and ``obs.export`` read phase 13(c)'s traced CLI run (a
    stage breakdown, a Chrome trace with at least two thread lanes).  K1's
    and K2's launches over the tables (counters reset first) and their
    error are their ``bench_path_*`` fields; the wall is logged beside
    ``BENCH_BUDGET_S``.
17. scale-out (run after phase 13, on its (a) dataset; ``phase_scaleout``):
    (a) ``repro_torch.scripts.generate_dataset --num-workers 2`` writes
    13(a)'s ×64 struct-only plan with two worker processes sharing
    the card: shards equal to 13(a)'s byte for byte, the workers' K2
    launches (their ``metrics.w*.json``) summing to 13(a)'s, the cluster's
    and 13(a)'s walls and each worker's stage seconds logged; (b) the same
    with ``kill_after={1: 1}``: two rounds, the same bytes, deep verify
    clean; (c) a featured ×4 ``--asset`` cluster of 2 workers equal to
    the serial featured run; (d) ``device_generate`` over four entries on
    ``cuda:0`` equal to the CPU's; (e) the examples ``trillion_edge_plan``
    (16 K2 launches) and ``serve_batched``; (f) ``cluster_scaling`` at its
    fast size, ``byte_identical``.  The wall is logged beside
    ``SCALE_BUDGET_S``; K2's row carries ``scaleout_path_launches`` (a) and
    ``scaleout_examples_launches`` (e).
18. training (run after phase 10, ``phase_training``): (a) full-width
    ``tinyllama-1.1b`` (22 layers, bf16, its config's 2 microbatches,
    einsum attention, remat ``"nothing"``; weights from
    ``init_params(PRNGKey(0))``, phase 9's) trained by ``Trainer`` for 6
    steps on B = 8 × S = 2048 tokens of a ``GraphWalkCorpus`` over the
    asset's ×1 ``generate`` (K2, held against its plain stream): every
    loss and grad norm finite, grad norms > 0, after step 1 every master
    moved and every leaf's first moment nonzero (no gradient cut); step
    ms, tokens/s, the model-FLOPs share (8·N·tokens over the bf16 dense
    peak) and peak memory beside the card's name and power limit; (b) the
    train step on the card against the CPU at the smoke width in float32
    (TF32 off), the same params, state and 2 batches: losses within
    ``CARD_CPU_LOSS_TOL``, masters within ``CARD_CPU_MASTER_TOL``; (c) at
    the fifth example's width, 10 steps with checkpoints every 5, a new
    ``Trainer`` resumed to 20 (history from step 11) against 20
    uninterrupted steps on the same batches (masters within 2·lr a step,
    bit equality logged), and a fault injected at step 12 recovered to
    20; (d) ``examples.train_lm_on_graph_corpus`` in-process at
    ``EXAMPLE_STEPS`` (its graph through K2, held against the plain
    stream): last-10 loss below first-10.  The wall is logged beside
    ``TRAIN_BUDGET_S``; K2's row carries ``train_path_launches`` and
    ``train_path_max_abs_err``.
19. the other LM families (run after phase 18, ``phase_families``), one
    at a time (``FAMILIES``): qwen3-moe-30b-a3b (8 of 48 layers),
    llama4-scout-17b-16e (2 of 48), pixtral-12b (8 of 40), zamba2-1.2b,
    rwkv6-7b and seamless-m4t-medium (not cut), bf16 at their published
    widths from ``init_params(PRNGKey(0))``, each cut logged with its
    reason: (a) the draw's seconds and peak memory; (b) one scoring
    forward of B = 2 × S = 2048 (VLM: 256 patches + 1792 tokens; encdec:
    1024 frames + 1024 tokens) through the flash path, every causal
    self-attention on K4's tensor-core route (8, 2, 8, 7, 0 and 12
    launches; d 128 for the first three), K4 against its plain version
    on the family's layer-0 q/k/v within 2e-2, the einsum path's loss
    within 2e-2 of the flash path's, ms and tokens/s; (c) the two MoE,
    the hybrid and the SSM through ``ServingEngine`` (8 requests, 4
    slots, 16 new tokens), every first token equal to ``Model.prefill``
    of its prompt from the cache the engine found in its slot (C16); the
    VLM and the encdec through ``Model.prefill`` with their patches or
    frames and 16 ``decode_step``s; decode tokens/s and peak memory;
    (d) card = CPU at each config's ``smoke()`` width in float32:
    logits within 1e-4 (the hybrid's 5e-4), the MoE's top-k ids and
    dispatch buffers equal, the hybrid's and the SSM's prefill + decode
    against the full forward.  The wall is logged beside
    ``FAMILY_BUDGET_S``; K4's row carries ``families_path_launches``
    and ``families_path_max_abs_err``.
20. training the other LM families (run after phase 19,
    ``phase_family_training``), one at a time (``TRAIN_FAMILIES``):
    qwen3-moe-30b-a3b (2 of 48 layers), pixtral-12b (4 of 40), zamba2-1.2b
    (whole, at its published SSD chunk of 128: ROADMAP C17), rwkv6-7b (8
    of 32) and seamless-m4t-medium (whole), each cut logged with its
    reason, llama4-scout-17b-16e left out with its reason; (a) bf16 from
    ``init_params(PRNGKey(0))``, remat ``"nothing"``, einsum attention,
    the config's own microbatches, ``FAMILY_TRAIN_STEPS`` ``Trainer``
    steps on B = 8 × S = 2048 positions of walk tokens over phase 18's ×1
    graph (the VLM: 256 seeded normal patches + 1792 tokens; the encdec:
    1024 frames + 1024 tokens): every loss and grad norm finite, grad
    norms > 0, after step 1 every master moved and every first moment
    nonzero, no K4 launch; the draw's seconds, step seconds, tokens/s,
    peak memory and the model-FLOPs share (8·N_active·tokens over the
    bf16 dense peak; the MoE's N_active counts the top-k experts of E)
    beside the card's name and power limit; (b) the train step card =
    CPU at each of the six ``smoke()`` widths in float32, 2 microbatches,
    the same params, state and 2 batches: losses within 18(b)'s limit,
    the first batch's gradients within ``FAMILY_GRAD_REL`` of each leaf's
    largest, masters within 18(b)'s
    limit where the first gradient is large enough for Adam's update to
    be sure of it (``_adam_sure``), within 2·(lr_1 + lr_2) elsewhere; the
    hybrid's ``FAMILY_TRAIN_CPU_TOL``.  The wall is logged beside
    ``FAMILY_TRAIN_BUDGET_S``.
21. the production mesh (run after phase 20, ``phase_plan``): (a)
    ``python -m repro_torch.launch.dryrun`` for every architecture at
    ``train_4k`` on the (16, 16) production mesh (its probe runs over
    ``PLAN_JOBS`` processes) and the graph-generation cell, on the host
    (a placeholder process group of 512 ranks, ``meta`` tensors, no
    card; ``PlanHost``: started before phase 18 at the lowest CPU
    priority, on the cores phases 18-20 leave idle, collected after
    (c)-(e) ran on the card): every cell ``ok`` or
    ``skipped``, each cell's peak bytes a device logged beside 80 GB
    (llama4-scout's ``fsdp`` cell among them) with its roofline terms,
    and ``benchmarks/roofline``'s two tables of the cells; (b) the
    memory model against the card: phase 18's step (tinyllama-1.1b, B =
    8 × S = 2048) probed on
    a 1 × 1 placeholder mesh, its predicted peak (plus phase 18's
    first-step weight copy) within ``PLAN_CALIB_TOL`` of phase 18's
    measured ``max_memory_allocated``, its counted FLOPs over phase 18's
    step time logged as a model-FLOPs share; (c) the mesh-aware step on a
    1 × 1 mesh of ``cuda:0`` (DTensor weights, full-width tinyllama-1.1b,
    2 steps) against the plain step from the same weights and batches:
    losses and masters within ``PLAN_STEP_TOL`` relative, bit-equality
    logged (masters held where Adam's first update is sure of its
    gradient, as phase 20 holds them); (d) ``compress_tree`` on the card
    = the CPU, bit for bit;
    (e) the generation cell on one device of the card: K2 for 2^24
    edges, its edges/s beside the cell's ``edges_per_s_roofline``, K2
    against its plain version at that shape.  The wall is logged beside
    ``PLAN_BUDGET_S``; K2's row carries ``plan_path_launches`` and
    ``plan_path_max_abs_err``.
22. the port checks itself (run after phase 21, ``phase_analysis``):
    (a) ``repro_torch.analysis.lint`` over its default scope against
    ``src/repro_torch/analysis/baseline.json``: no new finding; (b) two
    lockset stress runs at ``pipeline_depth=2`` with 2 host workers, K2
    in the struct stage — ``analysis.races.run_stress`` (KDE + random
    aligner) and the committed asset's GAN + GBDT ``FeatureSpec`` at ×1
    under ``races.instrument_job`` (draws and alignment on the card in
    the pool threads), 10 shards each: zero candidate races, the watched
    surface exercised, a dataset that verifies, shards equal to the same
    job at depth 0 on the card; (c) the kernel-library load audit
    (``analysis.retrace.run_retrace``) with ``cuda_prng`` and
    ``cuda_bits``: no ``nvcc`` start, no load in steady state; (d) K2's
    and K1's launches in (b)-(c) equal the plans' chunk counts, and each
    kernel equals its plain version on a chunk of every size there.  The
    wall is logged beside ``ANALYSIS_BUDGET_S``; K1's and K2's rows carry
    ``analysis_path_launches`` and ``analysis_path_max_abs_err``.

Phase 1 also builds the probes' torch-op library (``spike_ops.cpp`` with
``spike_elementwise.cu`` and ``spike.cu``) beside the ``ctypes`` libraries,
logs each library's build seconds, and fails if the SASS holds no 16-byte
loads and stores in the elementwise kernel, no 16-byte load in S4's and no
16-byte store in S3's.  Every ``kernels`` row carries ``device_us``
and ``library_device_us`` (per call, from the profiler; null where there
is no library call, or where the profiler did not keep every call's
kernel events), with ``device_calls`` (the calls traced) and
``device_kept`` / ``library_device_kept`` (the kernel events kept).

Every phase raises on failure.  The last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or outside a
checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import atexit
import contextlib
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"

sys.path.insert(0, str(ROOT / "src"))
try:
    # the H100's peaks and the kernels' bounds (one definition, shared
    # with repro_torch.benchmarks); the card's name and power limit
    from repro_torch.kernels.bounds import (
        ALU_LANES, FMA_HEAVY_LANES, HBM_BYTES_PER_S, ISSUE_LANES, PEAK_FLOPS,
        flash_bound_s, prng_bound_s, prng_kernel_bound_s, prng_level_clocks)
    from repro_torch.obs.metrics import gpu_line as nvidia_smi_line
except ImportError as e:
    print(f"chip_smoke: run it from a checkout of the repository ({e})",
          file=sys.stderr)
    sys.exit(1)

#: kernel shape of the scale-64 struct drawn unchunked (n=18, m=15), with
#: the demo θ; the main path itself draws 16 chunks of n=16, m=13
MAIN_N, MAIN_M, MAIN_E = 18, 15, 1 << 24
K_PREF = 2                              # generate()'s default chunking
DEMO_THETA = [0.45, 0.22, 0.2, 0.13]    # scripts/generate_dataset.py demo


#: the scoring path's attention shape: tinyllama-1.1b (32 heads, 4 kv
#: heads, head dim 64) at B = 4, S = 2048, folded as the layer folds it
LM_ARCH, LM_B, LM_S = "tinyllama-1.1b", 4, 2048
FLASH_PATH = dict(hq=LM_B * 32, hkv=LM_B * 4, s=LM_S, d=64)


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    line = nvidia_smi_line()
    check(line is not None, "nvidia-smi gave no name and power limit")
    return line


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


#: spin kernels (``torch.cuda._sleep``) traced before and after a timed
#: loop: in a long process the profiler was seen to drop one to three
#: kernel events of a trace, and with both edges padded by kernels that
#: are not read it kept every event of the loop
PROFILER_PAD = 8
SPIN_CYCLES = 20_000
#: the card's machine's profiler has kept no kernel event of a whole
#: 200-call trace: such a trace is taken again, this many times in all
PROFILER_TRIES = 3
#: rounds of (kernel, library) loops per probe; each takes its least: the
#: host's time per call varies by a fifth from loop to loop
PROBE_ROUNDS = 5


def device_us(fn, reps: int) -> tuple:
    """Device time per call of ``fn``, the names of the kernels it ran and
    how many of their events the profiler kept: ``torch.profiler``'s CUDA
    events over a loop of ``reps`` calls (after one untraced call, between
    ``PROFILER_PAD`` spin kernels on each side), their durations summed
    over the loop and divided by ``reps``.  The time is None unless every
    kernel kept a whole multiple of ``reps`` events, that is unless every
    call was seen.  A trace that kept no kernel event is taken again, up
    to ``PROFILER_TRIES`` traces."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def pad():
        for _ in range(PROFILER_PAD):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_TRIES):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            pad()
            for _ in range(reps):
                fn()
            pad()
        by_name = {}
        for e in prof.events():
            if (e.device_type == DeviceType.CUDA
                    and "spin_kernel" not in e.name):
                by_name.setdefault(e.name, []).append(
                    e.time_range.elapsed_us())
        if by_name:
            break
    kept = sum(map(len, by_name.values()))
    whole = by_name and all(len(d) % reps == 0 for d in by_name.values())
    per_call = (sum(map(sum, by_name.values())) / reps if whole else None)
    return per_call, sorted(by_name), kept


def us_text(us) -> str:
    return "not measured" if us is None else f"{us:.3f} us"


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


#: the in-register kernel's instance on the main path: narrow ids (32-bit
#: accumulators), a narrow counter (hi word 0), eight edges a thread; and
#: its twin of one edge a thread, for launches too small to fill the card
PRNG_MAIN_INSTANCE = "rmat_prng_kernelILb0ELb0ELi8E"
PRNG_SMALL_INSTANCE = "rmat_prng_kernelILb0ELb0ELi1E"
#: opcodes (first word) of the integer alu pipe and of the FMA-heavy pipe
ALU_OPCODES = ("SHF", "LOP3", "IADD3", "ISETP", "SEL", "LEA", "PRMT")
FMA_OPCODES = ("IMAD",)


def _sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` text as ``{function: [(address, opcode,
    operands)]}``."""
    import re
    fns, insts = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            insts = fns.setdefault(line.split("Function :", 1)[1].strip(), [])
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P[T0-9]\s+)?"
                       r"([A-Z][\w.]*)(.*)", line)
        if insts is not None and ins:
            insts.append((int(ins.group(1), 16), ins.group(2),
                          ins.group(3)))
    return fns


def sass_prng_loops(sass: str, kernel: str = PRNG_MAIN_INSTANCE) -> dict:
    """Static opcode counts of the in-register kernel's level loops in
    ``cuobjdump -sass`` text, per edge and level: the innermost backward
    branches whose range holds threefry rotations (``SHF.L.W``), in
    address order (the square segment, then the tail), each divided by
    its threefry copies (rotations / 20; one per edge of the thread).
    ``SHF.L.W`` counts the rotations and the ids' one-bit pushes.
    Backs the operation counts of its bound."""
    import re
    from collections import Counter
    out = {}
    for name, insts in _sass_functions(sass).items():
        if kernel not in name:
            continue
        # threefry's rotations: funnel shifts by its amounts (the id
        # pushes are funnel shifts by 1)
        rot = [a for a, op, rest in insts if op.startswith("SHF.L.W")
               and rest.split(",")[2].strip() != "0x1"]
        loops = set()
        for a, op, rest in insts:
            tgt = re.match(r"\s*0x([0-9a-f]+)", rest)
            if op == "BRA" and tgt and int(tgt.group(1), 16) < a:
                lo = int(tgt.group(1), 16)
                if any(lo <= r <= a for r in rot):
                    loops.add((lo, a))
        inner = sorted(lp for lp in loops if not any(
            o != lp and lp[0] <= o[0] and o[1] <= lp[1] for o in loops))
        for label, (lo, hi) in zip(("square", "tail"), inner):
            body = [op for a, op, _ in insts if lo <= a <= hi]
            copies = sum(lo <= a <= hi for a in rot) / 20
            ops = Counter(op.split(".")[0] for op in body)
            for wide in ("IMAD.IADD", "IMAD.SHL", "IMAD.MOV", "SHF.L.W",
                         "SHF.R"):
                n = sum(op.startswith(wide) for op in body)
                if n:
                    ops[wide] = n
            out[label] = {"threefry_copies": copies,
                          "instructions": len(body) / copies,
                          **{op: n / copies
                             for op, n in sorted(ops.items())}}
    return out


def ptxas_kernels(report: str, kernel: str) -> dict:
    """Registers, spills and shared memory of each template instance of
    ``kernel`` in a ``-Xptxas -v`` report, keyed by its template
    arguments."""
    import re
    out, name = {}, None
    for line in report.splitlines():
        fn = re.search(r"Compiling entry function '([^']+)'", line)
        if fn:
            name = fn.group(1) if kernel in fn.group(1) else None
            if name:
                key = re.search(kernel + r"(I.*?EE)", name)
                name = key.group(1) if key else name
                out[name] = {}
            continue
        if name is None:
            continue
        sp = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                       line)
        if sp:
            out[name].update(spill_stores=int(sp.group(1)),
                             spill_loads=int(sp.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            out[name]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out[name]["smem"] = int(smem.group(1)) if smem else 0
    return out


def read_sass(build, library) -> str:
    """``cuobjdump -sass`` of a built library ('' without the tool)."""
    tool = Path(build.nvcc()).with_name("cuobjdump")
    if not tool.exists():
        return ""
    return subprocess.run([str(tool), "-sass", str(library.path())],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


#: the opcodes that show a kernel runs on Hopper's tensor cores (HGMMA:
#: wgmma), is fed by TMA (UTMALDG: a tensor-map load) and waits on
#: mbarriers (SYNCS)
TC_OPCODES = ("HGMMA", "UTMALDG", "SYNCS")


def tc_opcode(op: str):
    """``TC_OPCODES`` by their first word (``HGMMA.64x64x16.F32.BF16``)."""
    head = op.split(".")[0]
    return head if head in TC_OPCODES else None


def wide_access(op: str):
    """A 16-byte global load or store (``LDG.E.128``, ``STG.E.128`` and
    their cache variants) as ``LDG.128``/``STG.128``."""
    words = op.split(".")
    return (f"{words[0]}.128" if words[0] in ("LDG", "STG") and "128" in words
            else None)


def sass_opcodes(sass: str, kernel: str, names=TC_OPCODES,
                 classify=tc_opcode) -> dict:
    """Static counts of the opcodes ``classify`` maps to one of ``names``
    in each SASS function whose name holds ``kernel`` (one per template
    instance)."""
    counts = {}
    for name, insts in _sass_functions(sass).items():
        if kernel in name:
            counts[name] = dict.fromkeys(names, 0)
            for _, op, _ in insts:
                key = classify(op)
                if key:
                    counts[name][key] += 1
    return counts


def loop_clocks(loop: dict) -> float:
    """SM clocks a level loop's static opcodes per edge and level take at
    least: its alu-pipe and FMA-pipe operations at their lanes, all its
    instructions at the issue limit."""
    alu = sum(loop.get(op, 0) for op in ALU_OPCODES)
    fma = sum(loop.get(op, 0) for op in FMA_OPCODES)
    return max(alu / ALU_LANES, fma / FMA_HEAVY_LANES,
               loop["instructions"] / ISSUE_LANES)


def prng_build_facts(reports: dict, build, rs) -> dict:
    """The in-register kernel as built: ``-Xptxas -v``'s registers and
    spills of each template instance, and the level loops of the main
    path's instance and its one-edge twin in the SASS, opcodes per edge
    and level.  Fails if the main instance's SASS holds no 16-byte store,
    or if its square loop's opcodes would take fewer clocks than
    ``bounds.prng_level_clocks``, which would make the bound no floor."""
    report = reports.get(rs.LIBRARY.name, ("", 0.0))[0]
    regs = ptxas_kernels(report, "rmat_prng_kernel")
    sass = read_sass(build, rs.LIBRARY)
    loops = sass_prng_loops(sass)
    small = sass_prng_loops(sass, PRNG_SMALL_INSTANCE)
    stores = sass_opcodes(sass, PRNG_MAIN_INSTANCE, ("STG.128",),
                          wide_access)
    floor = prng_level_clocks()
    log(f"ptxas: the prng kernel's instances (ILb<wide ids>ELb<wide "
        f"counter>ELi<edges a thread>EE): "
        f"{regs or 'not reported (built already)'}")
    log(f"sass: the prng kernel's level loops ({PRNG_MAIN_INSTANCE}), "
        f"static opcodes per edge and level: {loops or 'not read'}; "
        f"({PRNG_SMALL_INSTANCE}): {small or 'not read'}; its bound "
        f"takes {floor:.4f} SM clocks an edge and level (threefry's "
        "xors on the alu pipe, adds on either pipe, rotations split "
        "between them at best)")
    if sass:
        check(len(stores) == 1 and all(c["STG.128"] > 0
                                       for c in stores.values()),
              "the prng kernel's SASS holds no 16-byte store")
    if loops:
        need = {k: loop_clocks(v) for k, v in loops.items()}
        log(f"sass: the main instance's loops need at least "
            f"{ {k: round(v, 4) for k, v in need.items()} } SM clocks an "
            f"edge and level (alu ops / {ALU_LANES}, FMA ops / "
            f"{FMA_HEAVY_LANES}, instructions / {ISSUE_LANES})")
        check(need["square"] >= floor,
              f"the prng kernel's square loop needs {need['square']:.4f} SM "
              f"clocks a level, fewer than the {floor:.4f} its bound takes")
    return {"registers": regs, "sass_loops": loops,
            "sass_loops_one_edge": small}


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


def k2_vs_plain(g, st, launches: int, label: str, every: bool, tr, rmat,
                sampler, ref, rs, torch):
    """K2 at the shapes ``generate(seed=0, chunked=True)`` of the fit
    ``st`` gave it, with the run's own per-level θ (seed 0's θ-noise, the
    rng's first draw in generate): the kernel and the run's edges ``g``
    against the plain stream, for every chunk (``every``) or the largest
    and the smallest.  Returns the max error and the largest chunk's
    kernel arguments."""
    import numpy as np
    thetas = rmat.derive_thetas(st, rng=np.random.default_rng(0))
    plan = rmat.chunk_plan(st, K_PREF, thetas)
    check(len(plan) == launches,
          f"{label}: {len(plan)} chunks but {launches} launches")
    starts = np.cumsum([0] + [ck.n_edges for ck in plan])
    n_s, m_s = st.n - K_PREF, st.m - K_PREF
    th = torch.tensor(thetas[K_PREF:], dtype=torch.float32, device="cuda")
    sizes = [ck.n_edges for ck in plan]
    big = int(np.argmax(sizes))
    which = range(len(plan)) if every else sorted({big,
                                                   int(np.argmin(sizes))})
    err, largest = 0, None
    for i in which:
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
        if not every or i in (big, int(np.argmin(sizes))):
            log(f"{label} chunk {ck.index}: n={n_s} m={m_s} "
                f"E={ck.n_edges} stride={pad}, per-level θ: max|err| "
                f"prng-vs-plain={e_kern} run-vs-plain={e_run}")
        err = max(err, e_kern, e_run)
        if i == big:
            largest = (key, th, n_s, m_s, ck.n_edges, pad)
        del want
    log(f"{label}: K2 against the plain stream on {len(which)} of "
        f"{len(plan)} chunks: max|err| {err}")
    return err, largest


def phase_main_path(convert, tr, rmat, sampler, ref, rs, gops, torch):
    """``generate(scale_nodes=64, chunked=True)`` of the committed fit on
    the auto backend, then phase 14 (a)-(b) on its output.  Returns K2's
    launches in it, K2's max error at the shapes it gave K2, the largest
    chunk's kernel arguments, the pipeline and phase 14's numbers."""
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
    n_nodes = feats.shape[0]
    del feats

    err, largest = k2_vs_plain(g, st, launches["rmat_sample_prng"], "main "
                               "path", False, tr, rmat, sampler, ref, rs,
                               torch)
    check(err == 0, f"K2 disagrees at the main path's shapes (max {err})")
    fidelity = phase_fidelity_x64(g, cont, cat, torch)
    log(f"main path: non-finite node_features entries per column "
        f"[out_deg, in_deg, pagerank, log1p(katz)] = {bad} of {n_nodes} "
        f"nodes; the largest connected component holds "
        f"{fidelity['stats']['lcc']} nodes (Katz overflows float32 across "
        f"the giant component, as in the reference)")
    del g, cont, cat
    torch.cuda.empty_cache()
    return launches["rmat_sample_prng"], err, largest, pipe, fidelity


#: phase 14: card against CPU on the same tensors, float results within
#: this relative error (or ``FID_ABS`` absolute near 0); integers, the hop
#: plot and the effective diameter exactly
FID_REL, FID_ABS = 1e-9, 1e-12
#: phase 14's wall budget in seconds (the reused x64 generate not counted)
FID_BUDGET_S = 60.0
#: phase 14(e): a GCN trained 50 epochs on the card and on the CPU from the
#: same weights; final losses within this, test accuracies within 0.01
GNN_LOSS_TOL, GNN_ACC_TOL = 1e-4, 0.01
#: ``init_gnn``'s weights on the card against the CPU's: the port's
#: threefry normals are within 1e-6 of ``jax.random.normal`` on either
GNN_INIT_TOL = 1e-6
#: phase 14 (d) reruns the x64 fit's batched statistics in batches of this
#: many candidates (``EXPAND_BATCH`` is 2^27): 189 batches of its triangles
FID_SMALL_BATCH = 1 << 22


def _timed(fn, torch):
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def graph_stats(g, torch) -> tuple:
    """Every statistic of ``repro_torch.graph.ops`` on ``g``'s device,
    with Table 10's degree sequence (out + in; out and in side by side
    for a bipartite graph): values and the seconds of each."""
    import numpy as np
    from repro_torch.graph import ops as gops
    if g.bipartite:
        deg = torch.cat([gops.out_degrees(g), gops.in_degrees(g)])
    else:
        deg = gops.out_degrees(g) + gops.in_degrees(g)
    steps = (
        ("undirected_edges", lambda: int(gops._to_undirected(g)[0].numel())),
        ("max_degree", lambda: int(deg.max())),
        ("triangles", lambda: gops.triangle_stats(g)),
        ("wedges", lambda: gops.wedge_count(g)),
        ("clustering", lambda: gops.global_clustering(g)),
        ("assortativity", lambda: gops.degree_assortativity(g)),
        ("powerlaw", lambda: gops.powerlaw_exponent(deg[deg > 0])),
        ("gini", lambda: gops.gini_coefficient(deg)),
        ("entropy", lambda: gops.rel_edge_distribution_entropy(g)),
        ("lcc", lambda: gops.largest_connected_component(g)),
        ("hop_plot", lambda: gops.hop_plot(g).tolist()))
    vals, secs = {}, {}
    for name, fn in steps:
        vals[name], secs[name] = _timed(fn, torch)
    vals["triangles"], vals["triangle_candidates"] = vals["triangles"]
    vals["effective_diameter"] = gops.effective_diameter(
        np.asarray(vals["hop_plot"]))
    return vals, secs


def same_results(label: str, got: dict, want: dict) -> None:
    """``got`` (the card's) against ``want`` (the CPU's, or another call's
    on the card): ``None``, integers and lists exactly, floats within
    ``FID_REL``/``FID_ABS``."""
    import math
    bad = []
    for k, w in want.items():
        x = got[k]
        if isinstance(w, float) and isinstance(x, float):
            ok = (math.isnan(w) and math.isnan(x)) or math.isclose(
                x, w, rel_tol=FID_REL, abs_tol=FID_ABS)
        else:
            ok = x == w and type(x) is type(w)
        if not ok:
            bad.append(f"{k}: card {x!r} CPU {w!r}")
    log(f"{label}: {len(want) - len(bad)} of {len(want)} equal"
        + (f"; differ: {bad}" if bad else ""))
    check(not bad, f"{label}: results differ")


def phase_fidelity_x64(g, cont, cat, torch) -> dict:
    """Phase 14 (a)-(b) on the main path's own output (``generate(
    scale_nodes=64)`` of the committed fit).  (a) Table 2's scores against
    ``tabformer_like()``: each score alone, timed, then ``evaluate_all``,
    which must give the same numbers; all finite, ``degree_dist`` and
    ``feature_corr`` in [0, 1], ``dcc`` and ``degree_feat_dist`` ≥ 0.
    (b) Every graph statistic of that graph on the card with its seconds,
    the peak device memory over them."""
    import math
    from repro_torch.core import metrics
    from repro_torch.data.reference import tabformer_like
    t_phase = time.time()
    g_r, c_r, k_r = tabformer_like()
    g_rc = metrics._on(g_r, "cuda")
    scores, secs = {}, {}
    for name, fn in (
            ("degree_dist", lambda: metrics.degree_dist_similarity(g_rc, g)),
            ("dcc", lambda: metrics.dcc(g_rc, g)),
            ("feature_corr", lambda: metrics.feature_correlation_score(
                c_r, k_r, cont, cat)),
            ("degree_feat_dist", lambda: metrics.degree_feature_distance(
                g_rc, c_r[:, 0], g, cont[:, 0]))):
        scores[name], secs[name] = _timed(fn, torch)
    every, secs["evaluate_all"] = _timed(
        lambda: metrics.evaluate_all(g_r, c_r, k_r, g, cont, cat), torch)
    log(f"fidelity (a): Table 2 'ours' at x64 ({g.n_edges} edges) against "
        f"tabformer_like(): {json.dumps(scores)}; seconds "
        f"{json.dumps({k: round(v, 4) for k, v in secs.items()})}")
    same_results("fidelity (a) evaluate_all against the scores alone",
                 every, scores)
    check(all(math.isfinite(v) for v in scores.values()),
          f"non-finite score in {scores}")
    check(0 <= scores["degree_dist"] <= 1 and 0 <= scores["feature_corr"]
          <= 1 and scores["dcc"] >= 0 and scores["degree_feat_dist"] >= 0,
          f"a score out of its range: {scores}")
    t_a = time.time() - t_phase

    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    stats, stat_secs = graph_stats(g, torch)
    peak = torch.cuda.max_memory_allocated() / 1e9
    log(f"fidelity (b): the x64 graph's statistics on the card: "
        f"{json.dumps(stats)}; seconds "
        f"{json.dumps({k: round(v, 4) for k, v in stat_secs.items()})}; "
        f"peak device memory {peak:.2f} GB")
    check(all(math.isfinite(v) for v in stats["hop_plot"])
          and stats["lcc"] <= g.n_nodes, "x64 statistics out of range")
    check(g.bipartite and stats["triangles"] == 0,
          f"the bipartite x64 graph has {stats['triangles']} triangles")
    return dict(scores=scores, score_s=secs, stats=stats, stat_s=stat_secs,
                peak_mem_GB=peak, a_s=t_a, b_s=time.time() - t0)


def _sample_k2(fit, label: str, tr, rmat, sampler, ref, rs, torch):
    """``rmat.sample_graph(PRNGKey(0), fit)`` on the card's auto backend,
    its K2 launches counted (reset first), then K2's ids against the plain
    stream.  Returns the graph, its launches, the max error, seconds."""
    from repro_torch.graph.ops import Graph
    key = tr.PRNGKey(0)
    rs.reset_launches()
    (src, dst), secs = _timed(lambda: rmat.sample_graph(
        key, fit, backend="auto", device="cuda"), torch)
    launches = rs.LAUNCHES["rmat_sample_prng"]
    check(launches == 1, f"{label}: {launches} K2 launches, not 1")
    th = sampler._thetas_on(rmat.derive_thetas(fit, key=key), "cuda")
    pad = sampler._pad_edges(fit.E, sampler.choose_block(fit.E))
    want = ref.rmat_prng_ref(key, th, fit.n, fit.m, fit.E, pad)
    err = max(int((src.to(torch.int64) - want[0].lo).abs().max()),
              int((dst.to(torch.int64) - want[1].lo).abs().max()))
    check(err == 0, f"{label}: K2 disagrees with the plain stream ({err})")
    return Graph(src, dst, 2 ** fit.n, 2 ** fit.m), launches, err, secs


def gnn_epoch_s(g, kind: str, tr, torch, epochs: int = 3) -> tuple:
    """``benchmarks/gnn_throughput.py``'s epoch: hidden 128, 16-d features
    and labels from numpy, every node in the loss; one untimed epoch, then
    the mean of ``epochs``.  Returns seconds an epoch and the last loss."""
    import numpy as np
    from repro_torch.models import gnn
    cfg = gnn.GNNConfig(kind=kind)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        0, 1, (g.n_nodes, 16)).astype(np.float32)).cuda()
    y = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.n_classes, g.n_nodes)).cuda()
    mask = torch.ones(g.n_nodes, device="cuda")
    step, _ = gnn.make_node_classifier(cfg, g, "cuda")
    model = gnn.init_gnn(tr.PRNGKey(0), cfg, 16, "cuda")
    opt = [torch.zeros_like(p) for p in model.parameters()]
    step(model, opt, x, y, mask)
    loss, secs = _timed(lambda: [step(model, opt, x, y, mask)
                                 for _ in range(epochs)][-1], torch)
    return secs / epochs, float(loss)


def phase_fidelity(asset_pipe, tr, rmat, sampler, ref, rs, torch) -> dict:
    """Phase 14 (c)-(e).  (c) The asset at ``scale_nodes=4`` generated on
    the card (K2 against the plain stream on every chunk): ``evaluate_all``
    against ``tabformer_like()`` and every graph statistic on the card and
    on the CPU from the same tensors, equal (``same_results``).  (d) Table
    10: ``cora_like(n=2048, n_edges=8000)``, its ``fit_structure`` at
    noise 0.0 and 0.05 and the R-MAT default fit (as in
    ``benchmarks/table10_structural_stats.py``), each sampled by
    ``sample_graph(PRNGKey(0))`` through K2; statistics card = CPU; then
    the noise-0.05 fit at ``scale_nodes=64``, timed.  (e) GCN and GAT
    epochs (Table 4) on ``paysim_like(n=2048, n_edges=8000)`` and on its
    Kronecker fit sampled through K2 at scale 1 (the benchmark's) and at
    ``scale_nodes=16``; a 50-epoch GCN
    on ``cora_like()`` on the card and on the CPU from the same weights.
    Returns the numbers, K2's launches on this path and its max error."""
    import math
    from repro_torch.core import metrics
    from repro_torch.core.structure import KroneckerFit, fit_structure
    from repro_torch.data.reference import (cora_like, paysim_like,
                                            tabformer_like)
    from repro_torch.graph import ops as gops
    from repro_torch.models import gnn
    out, launches, err = {}, 0, 0

    # (c) card against CPU on the asset's x4 output
    t_phase = time.time()
    rs.reset_launches()
    (g4, c4, k4), gen_s = _timed(lambda: asset_pipe.generate(
        seed=0, scale_nodes=4, chunked=True), torch)
    n4 = rs.LAUNCHES["rmat_sample_prng"]
    e4, _ = k2_vs_plain(g4, asset_pipe.struct.scaled(4), n4, "fidelity (c)",
                        True, tr, rmat, sampler, ref, rs, torch)
    launches, err = launches + n4, max(err, e4)
    g_r, c_r, k_r = tabformer_like()
    card = metrics.evaluate_all(g_r, c_r, k_r, g4, c4, k4)
    cpu = metrics.evaluate_all(g_r, c_r, k_r, metrics._on(g4, "cpu"), c4.cpu(),
                               k4.cpu(), device="cpu")
    log(f"fidelity (c): x4 ({g4.n_edges} edges, generated in {gen_s:.3f}s) "
        f"Table 2 scores on the card {json.dumps(card)}")
    same_results("fidelity (c) evaluate_all x4", card, cpu)
    card_stats, _ = graph_stats(g4, torch)
    same_results("fidelity (c) statistics x4", card_stats,
                 graph_stats(metrics._on(g4, "cpu"), torch)[0])
    out["x4"] = dict(scores=card, stats=card_stats)
    del g4, c4, k4
    walls = {"c": time.time() - t_phase}

    # (d) Table 10 on the card
    t_phase = time.time()
    g_cora = metrics._on(cora_like(n=2048, n_edges=8000)[0], "cuda")
    fits = {"ours_no_noise": fit_structure(g_cora, noise=0.0),
            "ours_noise": fit_structure(g_cora, noise=0.05)}
    n = fits["ours_noise"].n
    fits["rmat_default"] = KroneckerFit(a=0.57, b=0.19, c=0.19, d=0.05, n=n,
                                        m=n, E=g_cora.n_edges)
    graphs = {"original": g_cora}
    for name, fit in fits.items():
        graphs[name], k, e, _ = _sample_k2(fit, f"fidelity (d) {name}", tr,
                                           rmat, sampler, ref, rs, torch)
        launches, err = launches + k, max(err, e)
    rows = {}
    for name, gg in graphs.items():
        rows[name], _ = graph_stats(gg, torch)
        same_results(f"fidelity (d) table10/{name}", rows[name],
                     graph_stats(metrics._on(gg, "cpu"), torch)[0])
        log(f"fidelity (d) table10/{name} (n={gg.n_nodes}, E={gg.n_edges}): "
            f"{json.dumps(rows[name])}")
    f64 = fits["ours_noise"].scaled(64)
    g64, k, e, sample_s = _sample_k2(f64, "fidelity (d) ours_noise x64", tr,
                                     rmat, sampler, ref, rs, torch)
    launches, err = launches + k, max(err, e)
    stats64, secs64 = graph_stats(g64, torch)
    log(f"fidelity (d) table10/ours_noise x64 (n=2^{f64.n}, E={f64.E}, "
        f"sampled in {sample_s:.3f}s): {json.dumps(stats64)}; seconds "
        f"{json.dumps({k: round(v, 4) for k, v in secs64.items()})}")
    check(stats64["triangles"] > 0, "the x64 cora fit has no triangles")
    batch = gops.EXPAND_BATCH
    try:
        gops.EXPAND_BATCH = FID_SMALL_BATCH
        (tri, cand), tri_s = _timed(lambda: gops.triangle_stats(g64), torch)
        hop, hop_s = _timed(lambda: gops.hop_plot(g64).tolist(), torch)
    finally:
        gops.EXPAND_BATCH = batch
    log(f"fidelity (d) ours_noise x64 in batches of {FID_SMALL_BATCH} "
        f"(>= {-(-cand // FID_SMALL_BATCH)} batches of triangle candidates): "
        f"triangles {tri_s:.4f}s, hop plot {hop_s:.4f}s")
    same_results("fidelity (d) ours_noise x64 in small batches",
                 dict(triangles=tri, triangle_candidates=cand, hop_plot=hop),
                 {k: stats64[k] for k in ("triangles", "triangle_candidates",
                                          "hop_plot")})
    g64_cpu = metrics._on(g64, "cpu")
    same_results("fidelity (d) ours_noise x64 wedges and lcc card = CPU",
                 {k: stats64[k] for k in ("wedges", "lcc")},
                 dict(wedges=gops.wedge_count(g64_cpu),
                      lcc=gops.largest_connected_component(g64_cpu)))
    del g64_cpu
    out["table10"] = dict(rows=rows, x64=stats64, x64_s=secs64)
    del g64
    walls["d"] = time.time() - t_phase

    # (e) GNN epochs (Table 4) and a 50-epoch GCN card against CPU
    t_phase = time.time()
    g_pay = metrics._on(paysim_like(n=2048, n_edges=8000)[0], "cuda")
    f_pay = fit_structure(g_pay)
    graphs = {"original": g_pay}
    for scale in (1, 16):
        graphs[f"ours_x{scale}"], k, e, _ = _sample_k2(
            f_pay.scaled(scale), f"fidelity (e) paysim fit x{scale}", tr,
            rmat, sampler, ref, rs, torch)
        launches, err = launches + k, max(err, e)
    epochs = {}
    for kind in ("gcn", "gat"):
        t_orig = None
        for name, gg in graphs.items():
            t, loss = gnn_epoch_s(gg, kind, tr, torch)
            check(math.isfinite(loss), f"{kind} on {name}: loss {loss}")
            t_orig = t if t_orig is None else t_orig
            epochs[f"{kind}/{name}"] = dict(epoch_s=t, n=gg.n_nodes,
                                            E=gg.n_edges)
            if name == "ours_x1":     # Table 4 compares graphs of one size
                epochs[f"{kind}/{name}"]["rel_timing"] = (
                    1.0 - abs(t - t_orig) / t_orig)
    log(f"fidelity (e): Table 4 epoch seconds (hidden 128, 16-d features, 3 "
        f"timed after 1), rel_timing of the x1 fit against the original: "
        f"{json.dumps(epochs)}")
    del graphs
    g, cont, cat = cora_like()
    cfg = gnn.GNNConfig()
    init = {dev: [p.detach().cpu() for p in gnn.init_gnn(
        tr.PRNGKey(0), cfg, cont.shape[1], dev).parameters()]
        for dev in ("cuda", "cpu")}
    d_init = max(float((a - b).abs().max())
                 for a, b in zip(init["cuda"], init["cpu"]))
    check(d_init <= GNN_INIT_TOL, f"init_gnn on the card is {d_init} from "
          f"the CPU's")
    runs = {}
    for dev in ("cuda", "cpu"):
        (_, acc, losses), secs = _timed(lambda: gnn.train_node_classifier(
            g, cont, cat[:, 0], cfg, epochs=50, device=dev), torch)
        runs[dev] = dict(final_loss=float(losses[-1]), test_acc=acc, s=secs)
    d_loss = abs(runs["cuda"]["final_loss"] - runs["cpu"]["final_loss"])
    d_acc = abs(runs["cuda"]["test_acc"] - runs["cpu"]["test_acc"])
    log(f"fidelity (e): 50-epoch GCN on cora_like() from init_gnn(PRNGKey(0))"
        f" on each (weights {d_init:.3g} apart, ≤ {GNN_INIT_TOL}): "
        f"{json.dumps(runs)}; |Δ final loss| {d_loss:.3g} (≤ {GNN_LOSS_TOL}),"
        f" |Δ test accuracy| {d_acc:.3g} (≤ {GNN_ACC_TOL})")
    check(d_loss <= GNN_LOSS_TOL and d_acc <= GNN_ACC_TOL,
          "the GCN trained on the card leaves the CPU's")
    out["gnn"] = dict(epochs=epochs, gcn50=runs)
    walls["e"] = time.time() - t_phase
    out.update(walls=walls, launches=launches, err=err)
    return out


#: the fit phase's draws: rows per generator, one block, seed 0
FIT_DRAW_ROWS = 40_000
#: port-trained generator against the asset's (JAX-trained) one, per
#: continuous column |Δmean| in units of the real column's std and the
#: std ratio, per categorical column the total-variation distance of the
#: category frequencies.  The card's fit drew 0.00065-0.019, 1.004-1.017
#: and ≤ 0.0027 (PERF.md); the bounds leave room because 200 adversarial
#: steps amplify the last-ulp differences of float sums, which differ by
#: card and library version
GAN_MEAN_TOL, GAN_STD_RATIO, GAN_TV_TOL = 0.1, (0.9, 1.1), 0.03
#: each draw against the real table, as the reference's
#: ``test_gan_learns_marginals`` holds a draw to its table (range, spread,
#: categories; not the mean: the JAX package's 200-step fit draws column
#: 0 at mean 1.62 against the table's 4.11): shares of each continuous
#: column inside the real column's range, std ratio to the real column's,
#: categorical total variation.  On the card both generators drew
#: 0.876-0.894, 0.857-0.986 and ≤ 0.102 (PERF.md)
REAL_IN_RANGE, REAL_STD_RATIO, REAL_TV_TOL = 0.8, (0.5, 2.0), 0.25
#: aligner holdout qualities against the asset's (equal on the card,
#: PERF.md): the card's PageRank/Katz sums can move a quantile bin edge
#: by an ulp and so a split
COL_QUALITY_TOL = 0.02
#: the negative control: a fresh fit stopped after this many of its 200
#: steps must miss the GAN bounds (its readings: PERF.md)
GAN_CONTROL_STEPS = 100


def _draw_stats(cont, cat, cards):
    import numpy as np
    cont = np.asarray(cont, np.float64)
    freq = [np.bincount(cat[:, j], minlength=c) / len(cat)
            for j, c in enumerate(cards)]
    return cont.mean(0), cont.std(0), freq


def _gan_close(name, got, want, real_std) -> bool:
    """Whether the draw stats ``got`` meet the bounds against the asset
    generator's ``want``; logs the readings."""
    import numpy as np
    (pm, ps, pf), (am, as_, af) = got, want
    dmean = np.abs(pm - am) / real_std
    ratio = ps / as_
    tv = [0.5 * np.abs(a - b).sum() for a, b in zip(pf, af)]
    log(f"fit: {name} vs asset generator: |Δmean|/std_real "
        f"{dmean.round(5).tolist()} (bound {GAN_MEAN_TOL}), std ratio "
        f"{ratio.round(5).tolist()} (bound {GAN_STD_RATIO}), categorical "
        f"TV {np.round(tv, 5).tolist()} (bound {GAN_TV_TOL})")
    return bool((dmean <= GAN_MEAN_TOL).all()
                and ((ratio >= GAN_STD_RATIO[0])
                     & (ratio <= GAN_STD_RATIO[1])).all()
                and max(tv) <= GAN_TV_TOL)


def _draw_meets_table(label: str, gen, cont, cat, cards) -> tuple:
    """``FIT_DRAW_ROWS`` rows (seed 0) of the generator ``gen`` held to the
    table ``cont``/``cat`` within the ``REAL_*`` bounds; returns the
    draw's stats."""
    import numpy as np
    real = _draw_stats(cont, cat, cards)
    lo, hi = cont.min(0), cont.max(0)
    c, k = gen.sample(np.random.default_rng(0), FIT_DRAW_ROWS)
    c, k = c.cpu().numpy(), k.cpu().numpy()
    check(c.shape == (FIT_DRAW_ROWS, cont.shape[1])
          and k.shape == (FIT_DRAW_ROWS, len(cards))
          and np.isfinite(c).all(), f"{label}: draw shape")
    check(bool(((k >= 0) & (k < np.asarray(cards))).all()),
          f"{label}: category out of range")
    mean, std, freq = stats = _draw_stats(c, k, cards)
    inside = ((c >= lo) & (c <= hi)).mean(0)
    ratio = std / real[1]
    tv = [0.5 * np.abs(a - b).sum() for a, b in zip(freq, real[2])]
    log(f"{label}, {FIT_DRAW_ROWS} rows vs the real table: cont mean "
        f"{mean.round(4).tolist()} (real {real[0].round(4).tolist()}), "
        f"std/real {ratio.round(4).tolist()}, in real range "
        f"{inside.round(4).tolist()}, categorical TV "
        f"{np.round(tv, 4).tolist()}")
    check((inside >= REAL_IN_RANGE).all()
          and ((ratio >= REAL_STD_RATIO[0])
               & (ratio <= REAL_STD_RATIO[1])).all()
          and max(tv) <= REAL_TV_TOL, f"{label}: the draw misses the table")
    return stats


#: phase 4b: rows of the aligner's inputs that ``predict_rows`` scores on
#: the card against the host trees, and the bound on the difference (both
#: sum ``base`` then ``lr * leaf`` tree by tree in float32)
PREDICT_ROWS, PREDICT_TOL = 2048, 1e-5


def predict_rows_vs_host(al, X, torch) -> tuple:
    """``al.predict_rows(X)`` on the card against the host's
    ``predict_np`` trees: the cont columns' max abs difference, and how far
    each categorical column's chosen class scores below the host's best
    class for its row (0 where the argmax agrees)."""
    import numpy as np
    got = al.predict_rows(X).cpu().numpy()
    Xh = X.cpu().numpy()
    nc = len(al.cont_models)
    err = max([float(np.abs(got[:, i] - m.predict_np(Xh)).max())
               for i, m in enumerate(al.cont_models)] + [0.0])
    gap = 0.0
    cats = [m for m in al.cat_models if m is not None]
    rows = np.arange(len(Xh))
    for j, m in enumerate(cats):
        scores = np.stack([r.predict_np(Xh) for r in m._class_models()], 1)
        pick = got[:, nc + j].astype(np.int64)
        gap = max(gap, float((scores.max(1) - scores[rows, pick]).max()))
    return err, gap


def phase_fit(convert, SyntheticGraphPipeline, GANFeatureGenerator,
              tabformer_like, asset_pipe, tr, rmat, sampler, ref, rs,
              torch) -> tuple:
    """The fit path at the asset's own settings: ``tabformer_like()``
    fitted by ``SyntheticGraphPipeline(noise=0.03, gan_steps=200)`` on the
    card, held against the committed asset (the JAX package's fit of the
    same table), then generating through K2.  Returns K2's launches in
    that generate, K2's max error at the shapes it gave K2 and the
    fitted pipeline."""
    import dataclasses
    import numpy as np
    from repro_torch.graph.ops import Graph
    g, cont, cat = tabformer_like()
    pipe = SyntheticGraphPipeline(noise=0.03, gan_steps=200, device="cuda")
    torch.cuda.synchronize()
    t0 = time.time()
    pipe.fit(g, cont, cat)
    torch.cuda.synchronize()
    wall = time.time() - t0
    tm = pipe.timings
    log(f"fit: tabformer_like() {g.n_src}x{g.n_dst} bipartite, "
        f"E={g.n_edges}, {cont.shape[1]} cont + {cat.shape[1]} cat columns, "
        f"noise=0.03, gan_steps=200, GBDT 100 rounds depth 5: "
        f"fit_struct_s={tm.fit_struct_s:.3f} fit_feat_s={tm.fit_feat_s:.3f} "
        f"fit_align_s={tm.fit_align_s:.3f} wall_s={wall:.3f} "
        f"({gpu_line()})")

    # 1-2: structure, schema and VGMs exactly the asset's
    got = dataclasses.asdict(pipe.struct)
    want = dataclasses.asdict(asset_pipe.struct)
    check(got == want, f"struct fit {got} != the asset's {want}")
    state = convert.state_from_pipeline(pipe)
    asset = convert.load_state(ASSET)
    check(set(state) == set(asset), "state keys differ from the asset's")
    for k in asset:
        check(state[k].shape == asset[k].shape
              and state[k].dtype == asset[k].dtype, f"{k}: shape or dtype")
        if k.startswith(("struct/", "schema/", "gan/vgm/", "pipe/")):
            check(np.array_equal(state[k], asset[k]), f"{k} differs")
    log(f"fit: struct {got} equals the asset's; schema and every "
        f"gan/vgm array equal; state keys, shapes and dtypes equal")

    # 3: the GAN, by what it draws
    losses = np.asarray(pipe.features._losses)
    check(losses.shape == (4, 2) and np.isfinite(losses).all(),
          f"GAN losses {losses.tolist()}")
    cards = pipe.schema.cat_cards
    real = _draw_stats(cont, cat, cards)
    stats = {name: _draw_meets_table(f"fit: {name} generator", gen, cont,
                                     cat, cards)
             for name, gen in (("port", pipe.features),
                               ("asset", asset_pipe.features))}
    log(f"fit: GAN losses (D, G) at steps 0/50/100/150 "
        f"{losses.round(4).tolist()}")
    check(_gan_close("port", stats["port"], stats["asset"], real[1]),
          "port GAN draws differ from the asset's")

    # 4: the aligner's holdout qualities
    q, q_asset = pipe.aligner.col_quality, asset["aligner/col_quality"]
    dq = float(np.abs(np.asarray(q) - q_asset).max())
    log(f"fit: col_quality {np.round(q, 6).tolist()} vs the asset's "
        f"{np.round(q_asset, 6).tolist()}: max |diff| {dq:.3g} (bound "
        f"{COL_QUALITY_TOL})")
    check(dq <= COL_QUALITY_TOL, "col_quality differs from the asset's")

    # 5-6: round trip, and generation from the port's fit through K2
    back = convert.pipeline_from_state(state, device="cuda")
    rs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    g1, c1, k1 = pipe.generate(seed=0, scale_nodes=4, chunked=True)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    launches = rs.LAUNCHES["rmat_sample_prng"]
    check(launches > 0, "generate from the port's fit never ran cuda_prng")
    g2, _, _ = asset_pipe.generate(seed=0, scale_nodes=4, chunked=True)
    g3, c3, k3 = back.generate(seed=0, scale_nodes=4, chunked=True)
    check(g1.n_edges == 640_000 and torch.equal(g1.src, g2.src)
          and torch.equal(g1.dst, g2.dst),
          "edges from the port's fit differ from the asset's")
    check(torch.equal(g1.src, g3.src) and torch.equal(g1.dst, g3.dst),
          "round trip changed the edges")
    X = pipe.aligner._inputs(Graph(g.src.cuda(), g.dst.cuda(), g.n_src,
                                   g.n_dst, g.bipartite))

    def scorers(al):
        return [m.predict for m in al.cont_models] + [
            m.predict_scores for m in al.cat_models if m is not None]

    score_err = max(float((fa(X) - fb(X)).abs().max()) for fa, fb in
                    zip(scorers(pipe.aligner), scorers(back.aligner)))
    check(score_err == 0.0, f"round trip changed GBDT scores ({score_err})")
    pred_err, pred_gap = predict_rows_vs_host(back.aligner,
                                              X[:PREDICT_ROWS], torch)
    check(pred_err <= PREDICT_TOL and pred_gap <= PREDICT_TOL,
          f"predict_rows on the card against the host trees: cont max "
          f"|diff| {pred_err}, class score gap {pred_gap} (bound "
          f"{PREDICT_TOL})")
    log(f"fit: predict_rows (packed scan) on {len(X[:PREDICT_ROWS])} rows "
        f"against predict_np: cont max |diff| {pred_err:.3g}, chosen "
        f"class's host score below the best by at most {pred_gap:.3g} "
        f"(bound {PREDICT_TOL})")
    log(f"fit: generate(seed=0, scale_nodes=4, chunked=True) from the "
        f"port's fit: {g1.n_edges} edges in {gen_s:.3f}s, {launches} K2 "
        f"launches; src/dst equal the asset pipeline's and the round "
        f"trip's; round-trip GBDT scores equal; features finite "
        f"{bool(torch.isfinite(c1).all())}")
    err, _ = k2_vs_plain(g1, pipe.struct.scaled(4), launches, "fit path",
                         True, tr, rmat, sampler, ref, rs, torch)
    check(err == 0, f"K2 disagrees at the fit path's shapes (max {err})")
    del g1, c1, k1, g2, g3, c3, k3, X

    # 7: where a training step's time goes: steps 3-6 of a fresh fit,
    # traced alone (the weights' init and step 0's loss read come before)
    enc = torch.as_tensor(pipe.features.codec.encode(cont, cat),
                          device="cuda")
    ctrl = GANFeatureGenerator(pipe.schema, pipe.features.cfg,
                               device="cuda", codec=pipe.features.codec)
    step = ctrl.trainer(enc)
    step()
    step()

    def four():
        for _ in range(4):
            step()

    trace_steps("gan training (steps 3-6 of a fresh fit)", four, 4, torch)
    # a wrong fit misses the GAN bounds: the same fit stopped at 100 of
    # its 200 steps
    for _ in range(GAN_CONTROL_STEPS - 6):
        step()
    c, k = ctrl.sample(np.random.default_rng(0), FIT_DRAW_ROWS)
    check(not _gan_close(f"{GAN_CONTROL_STEPS}-step control",
                         _draw_stats(c.cpu().numpy(), k.cpu().numpy(), cards),
                         stats["asset"], real[1]),
          f"a {GAN_CONTROL_STEPS}-step GAN passes the bounds of a 200-step "
          "one")
    del enc, ctrl, step, c, k
    torch.cuda.empty_cache()
    return launches, err, pipe


def _row_frac(c1, k1, c2, k2, torch) -> float:
    """The share of aligned rows equal on card and CPU (phases 5 and 15):
    categories equal and continuous values within 1e-5."""
    c1, k1, c2, k2 = (x.cpu() for x in (c1, k1, c2, k2))
    rows = (k1 == k2).all(1) & torch.isclose(c1, c2, rtol=1e-5,
                                             atol=1e-5).all(1)
    return rows.float().mean().item()


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
    frac = _row_frac(c1, k1, c2, k2, torch)
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


#: K2's other timing shapes in phase 11, with the demo θ: phase 21(e)'s
#: generation cell and Fig. 8's ``--full`` sweep at 2^24 edges, and phase
#: 13(a)'s mean chunk (163 840 000 edges in 15 923 chunks at k_pref 7)
K2_SHAPES = (("the generation cell of phase 21(e)", 30, 30, 1 << 24),
             ("Fig. 8 --full", 24, 24, 1 << 24),
             ("phase 13(a)'s mean chunk", 11, 8, 10_290))


def k2_reading(label: str, kern, plain, bound_s: float) -> dict:
    """K2 timed at one shape: CUDA-event ms (the least of two loops of
    10), profiler device µs, the plain version's ms, beside its bound;
    fails if the reading beats the bound (the bound would be no floor)."""
    ms = min(cuda_ms(kern, 10), cuda_ms(kern, 10))
    plain_ms = cuda_ms(plain, 1)
    dev_us, names, kept = device_us(kern, 5)
    share = bound_s * 1e3 / ms
    log(f"timing rmat_sample_prng at {label}: kernel {ms:.4f} ms (device "
        f"{us_text(dev_us)}: {', '.join(names)}, {kept} events of 5 calls "
        f"kept), plain {plain_ms:.3f} ms, bound {bound_s * 1e3:.4f} ms "
        f"(operations), {share:.1%} of it")
    check(share <= 1.0, f"K2 at {label} reads {share:.1%} of its bound")
    return {"shape": label, "ms": ms, "device_us": dev_us,
            "device_kept": kept, "plain_ms": plain_ms,
            "bound_ms": bound_s * 1e3, "of_bound": share}


def k2_at_shapes(tr, ref, rs, sampler, torch) -> list:
    """K2 at ``K2_SHAPES`` and on both sides of its switch to eight edges a
    thread (one group of eight for each lane of a warp on each of an SM's
    four schedulers): equal to its plain version there, then timed."""
    from functools import partial
    switch = torch.cuda.get_device_properties(0).multi_processor_count * \
        4 * 32 * 8
    out = []
    for what, n, m, E in K2_SHAPES + (
            ("one edge a thread, one group below the switch", 16, 13,
             switch - 8),
            ("eight edges a thread, at the switch", 16, 13, switch)):
        L = max(n, m)
        th = torch.tensor([DEMO_THETA] * L, dtype=torch.float32,
                          device="cuda")
        pad = sampler._pad_edges(E, sampler.choose_block(E))
        key = tr.PRNGKey(L)
        kern = partial(rs.rmat_sample_prng, key, th, n, m, E, pad)
        plain = partial(ref.rmat_prng_ref, key, th, n, m, E, pad)
        err = max_word_err(kern(), plain())
        check(err == 0, f"K2 at {what} differs from its plain version "
              f"({err})")
        label = f"n={n} m={m} L={L} E={E} stride={pad}: {what}, demo θ"
        out.append({**k2_reading(label, kern, plain,
                                 prng_kernel_bound_s(L, E)),
                    "max_abs_err": err})
    return out


def phase_timing(tr, ref, rs, sampler, torch, errs: dict, launches: dict,
                 largest) -> list:
    """Each kernel at the largest chunk the main path drew: K2 on its own
    arguments, K1 and K3 on the words (and uniforms) ``cuda_bits`` would
    draw for that chunk; then K2 at ``K2_SHAPES`` (its row's
    ``shapes``)."""
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
             prng_kernel_bound_s(L, E), "operations")):
        plain_ms = cuda_ms(plain, 2)
        ms = cuda_ms(kern, 10)
        ms2 = cuda_ms(kern, 10)
        plain_ms2 = cuda_ms(plain, 2)
        dev_us, dev_names, kept = device_us(kern, 5)
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
            "device_us": dev_us, "library_device_us": None,
            "device_calls": 5, "device_kept": kept,
            "library_device_kept": None, "shape": shape})
        log(f"timing {name}: kernel {ms:.4f}/{ms2:.4f} ms (device "
            f"{us_text(dev_us)}: {', '.join(dev_names)}, {kept} events of 5 "
            f"calls kept), plain {plain_ms:.3f}/{plain_ms2:.3f} ms, bound "
            f"{bound_s * 1e3:.4f} ms ({by}), {shape}")
    k2 = rows[-1]
    share = k2["bound_ms"] / k2["ms"]
    check(share <= 1.0, f"K2 at the largest chunk reads {share:.1%} of its "
          "bound")
    k2["shapes"] = [{"shape": shape, "ms": k2["ms"],
                     "device_us": k2["device_us"],
                     "device_kept": k2["device_kept"],
                     "plain_ms": k2["plain_ms"], "bound_ms": k2["bound_ms"],
                     "of_bound": share, "max_abs_err": errs[k2["name"]]}]
    k2["shapes"] += k2_at_shapes(tr, ref, rs, sampler, torch)
    log("library_ms: no single PyTorch call computes an R-MAT descend, so "
        "there is no library yardstick")
    return rows


#: phase 13's sizes: (a) the main path's full width, struct only; (b) the
#: card against the CPU; (c) features, alignment and kill/resume
STREAM_SCALE, STREAM_SHARD = 64, 1 << 24
STREAM_CPU_SCALE, STREAM_CPU_SHARD = 4, 1 << 18
STREAM_FEAT_SCALE, STREAM_FEAT_SHARD = 16, 1 << 21


def _tree(path) -> dict:
    """md5 of every shard file and the manifest of a dataset directory."""
    import hashlib
    import os
    out = {}
    for f in sorted(os.listdir(path)):
        if f.endswith(".npy") or f == "manifest.json":
            h = hashlib.md5()
            with open(os.path.join(path, f), "rb") as fh:
                for block in iter(lambda: fh.read(1 << 24), b""):
                    h.update(block)
            out[f] = h.hexdigest()
    return out


def _sans_executor(path) -> dict:
    """The manifest without its executor provenance (byte-transparent)."""
    import os
    with open(os.path.join(path, "manifest.json")) as f:
        d = json.load(f)
    d.pop("executor", None)
    return d


def _dir_bytes(path) -> int:
    import os
    return sum(os.path.getsize(os.path.join(path, f))
               for f in os.listdir(path))


def _stage_line(label: str, t: dict, rows: int) -> str:
    return (f"{label}: wall {t['wall_s']:.3f}s, busy struct "
            f"{t['gen_struct_s']:.3f}s feat {t['gen_feat_s']:.3f}s align "
            f"{t['gen_align_s']:.3f}s write {t['write_s']:.3f}s, overlap "
            f"{t['overlap']:.3f}, stall {t['stall_s']:.3f}s, "
            f"{rows / t['wall_s']:.4g} edges/s")


def _n_groups(sched, ds_source) -> int:
    """The struct stage's pump groups over every shard of a plan."""
    return sum(len(ds_source._chunk_groups(
        [sched.chunk(i) for i in rec.chunk_indices],
        ds_source.PUMP_GROUP_EDGES)) for rec in sched.shards)


def phase_datastream(convert, tr, rmat, sampler, ref, rs, torch,
                     trace_out: str, keep64: str) -> dict:
    """Phase 13: ``DatasetJob`` writes the committed fit to disk.

    (a) struct only at ``scale_nodes=64`` (163 840 000 int32 edges, shards
    of 2^24, ``pipeline_depth=2``, the auto backend): K2 must launch (its
    counter reset first); the deep verify finds nothing; the shards in
    order equal ``sample_graph_chunked`` of the job's key, k_pref and θ on
    the card; K2 equals its plain version on the largest chunk.  (A
    rerun pumped one chunk a group went for the smoke's wall:
    ``tests/test_torch_datastream.py::test_chunk_groups_keep_the_bytes``
    holds those bytes on the CPU.)
    (b) struct only at ``scale_nodes=4``: the card's dataset (``cuda_prng``)
    equals the CPU's (``cuda_bits``'s plain version) file for file,
    manifest included.
    (c) GAN features and the GBDT aligner at ``scale_nodes=16`` (10 240 000
    edges, shards of 2^21): serial, pipelined (depth 2, 2 host workers),
    pipelined and fused, and the CLI killed (SIGKILL) once its journal
    holds a record and then resumed, all byte-identical; the resumed run
    writes its event log (``--trace``) to ``trace_out`` for phase 16.
    (a)'s dataset is moved to ``keep64`` for phase 17.
    Returns K2's launches in (a), its max error and the run's numbers."""
    import dataclasses
    import os
    import shutil
    import signal
    import tempfile

    from repro_torch.datastream import (DatasetJob, FeatureSpec,
                                        ShardedGraphDataset)
    from repro_torch.datastream import source as ds_source

    state = convert.load_state(ASSET)
    pipe = convert.pipeline_from_state(state, device="cuda")
    work = tempfile.mkdtemp(prefix="chip_smoke_ds_")
    out = {}
    try:
        # (a) the main path's width, struct only
        fit = pipe.struct.scaled(STREAM_SCALE)
        path = os.path.join(work, "struct64")
        job = DatasetJob(fit, path, shard_edges=STREAM_SHARD, seed=0,
                         pipeline_depth=2)
        log(f"datastream (a): n={fit.n} m={fit.m} E={fit.E}, shard_edges "
            f"{STREAM_SHARD}, k_pref {job.k_pref}, "
            f"{len(job.scheduler.chunks)} chunks in "
            f"{len(job.scheduler.shards)} shards "
            f"({_n_groups(job.scheduler, ds_source)} pump groups of >= "
            f"{ds_source.PUMP_GROUP_EDGES} edges), backend {job.sampler} "
            f"(stream {job.backend}), no size cut")
        check(job.sampler == "cuda_prng", "the auto backend is not K2")
        rs.reset_launches()
        torch.cuda.synchronize()
        t0 = time.time()
        manifest = job.run()
        wall = time.time() - t0
        launches = dict(rs.LAUNCHES)
        t = job.timings
        check(manifest.is_complete(), "the scale-64 dataset is incomplete")
        check(launches["rmat_sample_prng"] == len(job.scheduler.chunks),
              f"K2 launched {launches['rmat_sample_prng']} times for "
              f"{len(job.scheduler.chunks)} chunks")
        nbytes = _dir_bytes(path)
        log(_stage_line("datastream (a) run", t, fit.E)
            + f"; outer wall {wall:.3f}s, {fit.E / wall:.4g} edges/s to "
            f"disk, {nbytes} bytes on disk, launches {launches}")
        t0 = time.time()
        problems = job.verify(deep=True)
        t_verify = time.time() - t0
        check(problems == [], f"deep verify: {problems[:3]}")
        rs.reset_launches()
        s, d = rmat.sample_graph_chunked(
            tr.PRNGKey(0), fit, k_pref=job.k_pref,
            thetas=job.scheduler.thetas, backend=job.sampler, device="cuda")
        off, mism = 0, 0
        for blk in ShardedGraphDataset(path):
            n = blk.n_edges
            mism += int((s[off: off + n].cpu().numpy() != blk.src).sum())
            mism += int((d[off: off + n].cpu().numpy() != blk.dst).sum())
            off += n
        check(off == fit.E and mism == 0,
              f"shards differ from sample_graph_chunked ({mism} ids)")
        del s, d
        big = max(job.scheduler.chunks, key=lambda c: c.n_edges)
        n_s, m_s = fit.n - job.k_pref, fit.m - job.k_pref
        th = torch.tensor(job.scheduler.thetas[job.k_pref:],
                          dtype=torch.float32, device="cuda")
        pad = sampler._pad_edges(big.n_edges,
                                 sampler.choose_block(big.n_edges))
        key = job.scheduler.key_for(big)
        err = max_word_err(
            rs.rmat_sample_prng(key, th, n_s, m_s, big.n_edges, pad),
            ref.rmat_prng_ref(key, th, n_s, m_s, big.n_edges, pad))
        check(err == 0, f"K2 disagrees on the largest chunk (max {err})")
        log(f"datastream (a): deep verify [] in {t_verify:.3f}s; shards == "
            f"sample_graph_chunked on the card; K2 vs plain on the largest "
            f"chunk (n={n_s} m={m_s} E={big.n_edges} stride={pad}): "
            f"max|err| {err}")
        out.update(launches=launches["rmat_sample_prng"], err=err,
                   fit64=dataclasses.asdict(fit),
                   wall_s=wall, edges_per_s=fit.E / wall, bytes=nbytes,
                   timings=dict(t), chunks=len(job.scheduler.chunks),
                   shards=len(job.scheduler.shards))

        # (b) the card against the CPU
        fit4 = pipe.struct.scaled(STREAM_CPU_SCALE)
        dirs = {}
        for dev, backend in (("cuda", None), ("cpu", "cuda_bits")):
            dirs[dev] = os.path.join(work, f"struct4-{dev}")
            job4 = DatasetJob(fit4, dirs[dev], shard_edges=STREAM_CPU_SHARD,
                              seed=0, backend=backend, device=dev)
            job4.run()
        same = _tree(dirs["cuda"]) == _tree(dirs["cpu"])
        log(f"datastream (b): scale {STREAM_CPU_SCALE} (E={fit4.E}, "
            f"{len(job4.scheduler.shards)} shards): card (cuda_prng) vs "
            f"CPU (cuda_bits plain) files and manifest identical: {same}")
        check(same, "the card's dataset differs from the CPU's")

        # (c) features, alignment, kill and resume
        fit16 = pipe.struct.scaled(STREAM_FEAT_SCALE)
        spec = FeatureSpec(pipe.features, pipe.aligner)
        runs = {"serial": dict(pipeline_depth=0, double_buffered=False),
                "pipelined": dict(pipeline_depth=2, host_workers=2),
                "fused": dict(pipeline_depth=2, host_workers=2,
                              fused=True)}
        trees, feat = {}, {}
        for name, kw in runs.items():
            p = os.path.join(work, f"feat-{name}")
            jobf = DatasetJob(fit16, p, shard_edges=STREAM_FEAT_SHARD,
                              seed=0, features=spec, **kw)
            torch.cuda.synchronize()
            jobf.run()
            trees[name] = _tree(p)
            feat[name] = dict(jobf.timings)
            log(_stage_line(f"datastream (c) {name}", jobf.timings,
                            fit16.E))
        check(jobf.verify(deep=True) == [], "featured dataset verify")
        n_feat_shards = len(jobf.scheduler.shards)
        cli = os.path.join(work, "feat-cli")
        cmd = [sys.executable, "-m", "repro_torch.scripts.generate_dataset",
               "--asset", str(ASSET), "--scale-nodes",
               str(STREAM_FEAT_SCALE), "--shard-edges",
               str(STREAM_FEAT_SHARD), "--out", cli, "--pipeline-depth",
               "2", "--host-workers", "2"]
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        journal = os.path.join(cli, "progress.jsonl")
        proc = subprocess.Popen(cmd, env=env, stdout=subprocess.DEVNULL,
                                stderr=subprocess.PIPE, text=True)
        t0 = time.time()
        try:
            while proc.poll() is None and time.time() - t0 < 300:
                if os.path.exists(journal) and os.path.getsize(journal):
                    break
                time.sleep(0.05)
            killed = proc.poll() is None
            if killed:
                proc.send_signal(signal.SIGKILL)
            proc.wait(timeout=60)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        with open(journal) as f:
            at_kill = sum(1 for line in f if line.strip())
        check(killed and at_kill < n_feat_shards,
              f"the CLI was not killed mid-run (killed={killed}, "
              f"{at_kill} of {n_feat_shards} shards journaled)")
        r = subprocess.run(cmd + ["--resume", "--verify", "--trace",
                                  trace_out], env=env,
                           capture_output=True, text=True, timeout=600)
        check(r.returncode == 0, f"the resumed CLI failed: "
              f"{r.stderr[-2000:]}")
        trees["cli"] = _tree(cli)
        resumed = [ln for ln in r.stderr.splitlines()
                   if ln.startswith(("materialized", "stages"))]
        log(f"datastream (c) cli: SIGKILLed after {at_kill} of "
            f"{n_feat_shards} shards journaled, resumed: "
            + "; ".join(resumed))
        shards_only = {name: {f: h for f, h in files.items()
                              if f != "manifest.json"}
                       for name, files in trees.items()}
        base = shards_only["serial"]
        same = {name: h == base for name, h in shards_only.items()}
        manif = {name: _sans_executor(os.path.join(work, f"feat-{name}"))
                 == _sans_executor(os.path.join(work, "feat-serial"))
                 for name in trees}
        log(f"datastream (c): scale {STREAM_FEAT_SCALE} (E={fit16.E}, "
            f"{n_feat_shards} shards, {len(base)} files): shard files equal "
            f"to serial: {same}; manifests equal bar the executor: {manif}")
        check(all(same.values()) and all(manif.values()),
              "featured runs are not byte-identical")
        out.update(features=feat, feat_shards=n_feat_shards,
                   killed_after=at_kill)

        # (d) each dataset fitted back
        out["refit"] = phase_refit(
            work, path, dirs["cuda"], os.path.join(work, "feat-serial"),
            tr, rmat, sampler, ref, rs, torch)
        os.rename(path, keep64)
    finally:
        shutil.rmtree(work, ignore_errors=True)
        del pipe
        torch.cuda.empty_cache()
    return out


#: phase 13(d): the featured refit's row sample, the size of the table
#: phase 4b fits
REFIT_SAMPLE_ROWS = 40_000
#: phase 13(d)(c): the refit's GBDT aligner rounds, a tenth of the
#: asset's 100: a depth cut for the smoke's wall that phase 15 took (the
#: host GBDT fit took 62-76 s of the refit, 39.8 s at 50 rounds).  Fewer
#: sample rows fail the refit GAN's draw check instead: 0.632 of a column
#: in range at 10 000 rows (bound 0.8, PERF.md)
REFIT_GBDT_ROUNDS = 10
#: the JAX package's round-trip tolerances (``tests/test_fit_engine.py``):
#: the bit-pair MLE against the θ the dataset was drawn with, the fit
#: against the generator's θ (``fit_dataset --check-theta``)
REFIT_MLE_TOL, REFIT_THETA_TOL = 0.02, 0.07
#: the fit JSON of (a)'s dataset, pinned: written on the card by
#: ``tests/fixtures/make_refit64.py``; ``tests/test_torch_fit_engine.py``
#: feeds its stats to both packages' ``fit_structure_streamed`` on the
#: CPU and gets these bytes back
REFIT64_JSON = ROOT / "tests" / "fixtures" / "refit64.json"


def _theta_errs(label: str, prov: dict, path: str) -> None:
    """Holds a refit's MLE to the manifest's per-level θ, averaged over
    the min(n, m) levels whose bit pairs it counts: with θ-noise (the
    asset's 0.03) that mean, not the base θ, is what the MLE estimates.
    Logs the MLE's distance to the base θ beside it."""
    import numpy as np
    from repro_torch.datastream import ShardedGraphDataset
    man = ShardedGraphDataset(path).manifest
    lv = min(man.fit["n"], man.fit["m"])
    drawn = np.asarray(man.theta)[:lv].mean(0)
    base = np.asarray([man.fit[k] for k in "abcd"])
    mle = np.asarray(prov["theta_mle"])
    err = float(np.abs(mle - drawn).max())
    log(f"{label}: MLE {mle.round(5).tolist()}, the manifest's per-level θ "
        f"over {lv} levels {drawn.round(5).tolist()}: max|err| {err:.5f} "
        f"(bound {REFIT_MLE_TOL}); base θ {base.round(5).tolist()}: "
        f"max|err| {float(np.abs(mle - base).max()):.5f}")
    check(err <= REFIT_MLE_TOL, f"{label}: the MLE misses the drawn θ")


def _span_totals(trace_path: str) -> dict:
    from repro_torch.obs import load_events
    tot = {}
    for ev in load_events(trace_path):
        if ev.get("ev") == "span":
            n, d = tot.get(ev["name"], (0, 0.0))
            tot[ev["name"]] = (n + 1, d + ev["dur"])
    return tot


def phase_refit(work: str, path64: str, path4: str, path16: str, tr, rmat,
                sampler, ref, rs, torch) -> dict:
    """Phase 13(d): the datasets of (a)-(c) fitted back on the card.

    (a) ``repro_torch.scripts.fit_dataset.main`` with ``--check-theta
    0.07`` over the ×64 dataset (2^20-row chunks), called in this process
    (a second interpreter took ~10 s more of the smoke's wall; phase
    13(c) runs a CLI as its own process): its fit JSON equal, byte for
    byte, to ``REFIT64_JSON`` (which both packages reproduce on the CPU
    from its stats: the calibrated choice and θ are the JAX package's);
    its exit code 1 exactly when its θ check misses; the MLE within
    ``REFIT_MLE_TOL`` of the θ the shards were drawn with.  Then the same
    fit in this process with the shards streamed in reverse: the fit
    JSON identical, and the uncalibrated (MLE + Eq. 6) fit within
    ``REFIT_THETA_TOL`` of the generator's θ.
    (b) ``accumulate`` + ``fit_structure_streamed`` of the ×4 dataset on
    the card and on the CPU: the fit JSON identical.
    (c) ``fit_streamed`` of the featured ×16 dataset at the asset's
    settings but ``REFIT_GBDT_ROUNDS`` aligner rounds, on
    ``REFIT_SAMPLE_ROWS`` rows: its cardinalities the
    dataset's, GAN losses finite, the refit generator's draw within the
    ``REAL_*`` bounds of the sample; then ``generate(seed=0,
    scale_nodes=1, chunked=True)`` from it (scale 1 keeps the smoke's
    wall; the draw is held at phase 4's ×64), with K2's counter reset
    first: K2 must launch, and K2 and the run's edges equal the plain
    stream on every chunk.  Returns the numbers and K2's launches and
    max error."""
    import dataclasses
    import os
    import numpy as np
    from repro_torch.core import fit_engine as fe
    from repro_torch.core.aligner import AlignerConfig
    from repro_torch.core.pipeline import SyntheticGraphPipeline
    from repro_torch.datastream import DatasetFitSource, ShardedGraphDataset
    from repro_torch.scripts.fit_dataset import generator_provenance
    out = {}

    # (a) the CLI's main over the x64 dataset, then the shards reversed
    import contextlib
    import io
    from repro_torch.scripts import fit_dataset
    t_phase = time.time()
    fit_json = os.path.join(work, "refit64.json")
    metrics = os.path.join(work, "refit64.metrics.json")
    trace = os.path.join(work, "refit64.trace.jsonl")
    argv = ["--dataset", path64, "--out", fit_json, "--check-theta",
            str(REFIT_THETA_TOL), "--trace", trace, "--metrics-out", metrics]
    err_text = io.StringIO()
    t0 = time.time()
    with contextlib.redirect_stderr(err_text):
        rc = fit_dataset.main(argv)
    torch.cuda.synchronize()
    cli_wall = time.time() - t0
    check(rc in (0, 1) and os.path.exists(metrics),
          f"fit_dataset failed: {err_text.getvalue()[-2000:]}")
    with open(fit_json) as f:
        text = f.read()
    with open(metrics) as f:
        m = json.load(f)["metrics"]
    spans = _span_totals(trace)
    prov = json.loads(text)["provenance"]
    rate = m["rows"] / m["timings"]["accumulate_s"]
    met = m["theta_err"] <= REFIT_THETA_TOL
    log(f"refit (a): fit_dataset over the x64 dataset ({m['rows']} rows, "
        f"{m['n_chunks']} chunks): call wall {cli_wall:.3f}s, "
        f"accumulate {m['timings']['accumulate_s']:.3f}s ({rate:.4g} "
        f"rows/s), θ-fit {m['timings']['theta_fit_s']:.3f}s; trace spans "
        f"(count, seconds) {spans}; chosen {prov['chosen']} of "
        f"{prov['calibration']}; " + " ".join(
            ln for ln in err_text.getvalue().splitlines()
            if ln.startswith("θ")))
    # the calibration ladder scores 200 000-edge samples against the
    # whole dataset's degree histograms; at the x64 density (~625 edges a
    # node) it chooses a skew candidate past the tolerance, and the JAX
    # package chooses the same from the same stats (ROADMAP C8).  So the
    # fit is held to the pinned JSON, and the CLI to its exit code
    pinned = text == REFIT64_JSON.read_text()
    log(f"refit (a): --check-theta {REFIT_THETA_TOL}: max|θ_fit − θ_gen| "
        f"{m['theta_err']:.5f}, {'met' if met else 'MISSED'}, exit code "
        f"{rc}; fit JSON equal to {REFIT64_JSON.name}: {pinned}")
    check(pinned, f"the x64 fit JSON differs from {REFIT64_JSON.name}")
    check(rc == (0 if met else 1),
          "fit_dataset's exit code disagrees with its θ check")
    _theta_errs("refit (a)", prov, path64)
    n_shards = len(ShardedGraphDataset(path64))
    src = DatasetFitSource(path64, shard_order=list(range(n_shards))[::-1])
    torch.cuda.synchronize()
    t0 = time.time()
    stats = fe.accumulate(src, device="cuda")
    t_rev = time.time() - t0
    fit, prov_rev = fe.fit_structure_streamed(stats, device="cuda")
    prov_rev["generator"] = generator_provenance(src.ds.manifest)
    same = fe.fit_to_json(fit, prov_rev) == text
    man_fit = src.ds.manifest.fit
    eq6, _ = fe.fit_structure_streamed(stats, calibrate=False,
                                       device="cuda")
    eq6_err = max(abs(getattr(eq6, k) - man_fit[k]) for k in "abcd")
    log(f"refit (a): in-process, {n_shards} shards reversed: accumulate "
        f"{t_rev:.3f}s ({stats.rows / t_rev:.4g} rows/s); fit JSON "
        f"identical to the CLI's: {same}; without calibration (MLE + "
        f"Eq. 6) θ = ({eq6.a:.5f}, {eq6.b:.5f}, {eq6.c:.5f}, {eq6.d:.5f}), "
        f"max|θ − θ_gen| {eq6_err:.5f}")
    check(same, "the x64 fit JSON depends on the shard order")
    check(eq6_err <= REFIT_THETA_TOL, f"the uncalibrated x64 fit is "
          f"{eq6_err:.5f} from the generator's θ")
    out.update(cli_wall_s=cli_wall, rows=m["rows"], chunks=m["n_chunks"],
               timings=m["timings"], rows_per_s=rate, spans=spans,
               reversed_accumulate_s=t_rev, chosen=prov["chosen"],
               theta_err=m["theta_err"], check_theta_met=met,
               eq6_theta_err=eq6_err)
    walls = {"a": time.time() - t_phase}

    # (b) the card against the CPU
    t_phase = time.time()
    texts = {}
    for dev in ("cuda", "cpu"):
        st = fe.accumulate(DatasetFitSource(path4), device=dev)
        texts[dev] = fe.fit_to_json(*fe.fit_structure_streamed(
            st, device=dev))
    log(f"refit (b): the x4 dataset ({st.rows} rows) on the card and on "
        f"the CPU: fit JSON identical: {texts['cuda'] == texts['cpu']}")
    check(texts["cuda"] == texts["cpu"], "the card's fit JSON differs from "
          "the CPU's")
    walls["b"] = time.time() - t_phase

    # (c) features, then generation from the refit through K2; one pass
    # builds the stats, whose sample the fit trains on and the draw meets
    t_phase = time.time()
    gbdt = dataclasses.replace(AlignerConfig().gbdt,
                               n_rounds=REFIT_GBDT_ROUNDS)
    pipe = SyntheticGraphPipeline(noise=0.03, gan_steps=200, device="cuda",
                                  aligner_cfg=AlignerConfig(gbdt=gbdt))
    torch.cuda.synchronize()
    t0 = time.time()
    stats16 = fe.accumulate(DatasetFitSource(path16),
                            sample_rows=REFIT_SAMPLE_ROWS, device="cuda")
    torch.cuda.synchronize()
    t_acc16 = time.time() - t0
    pipe.fit_streamed(stats16)
    wall = time.time() - t0
    tm = pipe.timings
    log(f"refit (c): fit_streamed of the featured x16 dataset's stats, "
        f"{REFIT_SAMPLE_ROWS} sample rows, noise=0.03, gan_steps=200, GBDT "
        f"{REFIT_GBDT_ROUNDS} rounds depth 5: accumulate {t_acc16:.3f}s "
        f"fit_struct_s={tm.fit_struct_s:.3f} "
        f"fit_feat_s={tm.fit_feat_s:.3f} fit_align_s={tm.fit_align_s:.3f} "
        f"wall_s={wall:.3f}; struct {pipe.struct}, chosen "
        f"{pipe.fit_provenance.get('chosen')}")
    _theta_errs("refit (c)", pipe.fit_provenance, path16)
    ds = ShardedGraphDataset(path16)
    cards = tuple(int(c) + 1 for c in np.max(
        [np.asarray(b.cat).max(0) for b in ds], axis=0))
    check(pipe.schema.cat_cards == cards and pipe.schema.n_cont == 2,
          f"refit schema {pipe.schema} against the dataset's {cards}")
    losses = np.asarray(pipe.features._losses)
    check(losses.shape == (4, 2) and np.isfinite(losses).all(),
          f"refit GAN losses {losses.tolist()}")
    sample = stats16.sample
    _draw_meets_table("refit (c): the refit generator", pipe.features,
                      sample["cont"], sample["cat"], cards)
    rs.reset_launches()
    torch.cuda.synchronize()
    t0 = time.time()
    g, c, k = pipe.generate(seed=0, scale_nodes=1, chunked=True)
    torch.cuda.synchronize()
    gen_s = time.time() - t0
    launches = rs.LAUNCHES["rmat_sample_prng"]
    check(launches > 0, "generate from the refit never ran cuda_prng")
    st1 = pipe.struct.scaled(1)
    check(g.n_edges == st1.E and bool(torch.isfinite(c).all())
          and tuple(k.shape) == (st1.E, len(cards)),
          "generate from the refit: shapes or non-finite features")
    tg = pipe.timings
    log(f"refit (c): generate(seed=0, scale_nodes=1, chunked=True): "
        f"{g.n_edges} edges in {gen_s:.3f}s (gen_struct_s "
        f"{tg.gen_struct_s:.3f}, gen_feat_s {tg.gen_feat_s:.3f}, "
        f"gen_align_s {tg.gen_align_s:.3f}), {launches} K2 launches")
    walls["c_fit_and_draw"] = t0 - t_phase
    walls["c_generate"] = gen_s
    t_phase = time.time()
    err, _ = k2_vs_plain(g, st1, launches, "refit path", True, tr, rmat,
                         sampler, ref, rs, torch)
    check(err == 0, f"K2 disagrees at the refit path's shapes (max {err})")
    walls["c_k2_vs_plain"] = time.time() - t_phase
    log("refit: wall per part (s) " + json.dumps(
        {name: round(v, 3) for name, v in walls.items()}))
    out.update(walls=walls,
               feat_timings=dict(accumulate_s=t_acc16,
                                 fit_struct_s=tm.fit_struct_s,
                                 fit_feat_s=tm.fit_feat_s,
                                 fit_align_s=tm.fit_align_s, wall_s=wall),
               gen_s=gen_s, gen_edges=g.n_edges, launches=launches,
               err=err)
    del g, c, k, pipe, stats16
    torch.cuda.empty_cache()
    return out


#: phase 15 (baselines): Table 6's grid at x4 (640 000 edges), Table 2's
#: three methods at x4 too (x16 until phase 16 pushed the smoke past 500
#: s: 11.8-13.1 s of (b)), ``ERGenerator`` at x64 (163 840 000 edges) and
#: ``sample_erdos_renyi`` at Table 8's full sizes on 2^20 x 2^20 nodes,
#: whose ids at 2^20 edges the CPU draws too (2^23, 6.4 s of CPU
#: threefry, until the same)
BASE_GRID_SCALE, BASE_T2_SCALE, BASE_ER_SCALE = 4, 4, 64
T8_NODES, T8_EDGES, T8_CPU_EDGES = 1 << 20, (1 << 20, 1 << 23, 1 << 25), \
    1 << 20
#: phase 15(a): the scale at which the GBDT-aligned KDE and random rows
#: are drawn on the card and on the CPU and held to phase 4's criterion.
#: x1, a depth cut for the phase's wall: (a) took 45.5 s with the six at
#: x4 (the CPU's GBDT inference) and 14.8 s at x1 on the card's host; at
#: x4 the six were equal on 100% of rows (PERF.md)
BASE_GBDT_CPU_SCALE = 1
#: phase 15(d): the KDE + random-aligner dataset, x4 in shards of 2^18
#: edges (3 shards; the CPU's plain K2 pays per chunk)
BASE_DS_SCALE, BASE_DS_SHARD = 4, 1 << 18
#: phase 15's wall budget in seconds
BASE_BUDGET_S = 60.0


def _same_bytes(a, b) -> bool:
    """Tensors equal byte for byte (floats by their bit patterns)."""
    import torch
    a, b = a.cpu(), b.cpu()
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b)


def _baseline_parts(asset_pipe, cpu_pipe, g_r, c_r, k_r, dev: str) -> dict:
    """Table 6's components on ``dev``, fitted once as
    ``benchmarks/table6_ablation.py`` fits them: the asset's kronecker
    structure, GAN and GBDT aligner; SBM, ER, KDE and random fitted on
    ``tabformer_like()``; the random aligner."""
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.baselines import ERGenerator, SBMGenerator
    from repro_torch.core.features import (KDEFeatureGenerator,
                                           RandomFeatureGenerator)
    from repro_torch.graph.ops import Graph
    base = asset_pipe if dev == "cuda" else cpu_pipe
    gd = Graph(g_r.src.to(dev), g_r.dst.to(dev), g_r.n_src, g_r.n_dst,
               g_r.bipartite)
    schema = base.schema
    return dict(
        struct={"kronecker": base.struct,
                "sbm": SBMGenerator(device=dev).fit(gd),
                "er": ERGenerator(device=dev).fit(gd)},
        features={"gan": base.features,
                  "kde": KDEFeatureGenerator(schema, device=dev).fit(c_r,
                                                                     k_r),
                  "random": RandomFeatureGenerator(schema, dev).fit(c_r,
                                                                   k_r)},
        aligner={"xgboost": base.aligner, "random": RandomAligner(schema)})


def phase_baselines(asset_pipe, fit_pipe, tr, rmat, sampler, ref, rs,
                    torch) -> dict:
    """Phase 15: the paper's baselines on the card.  (a) Table 6's grid:
    the components of ``_baseline_parts`` recomposed by
    ``SyntheticGraphPipeline.fitted`` into all 18 combinations, each
    ``generate(seed=0, scale_nodes=4, chunked=True)`` scored by
    ``evaluate_all`` against ``tabformer_like()``; the six without the GAN
    or the GBDT aligner drawn on the CPU too (the kronecker rows through
    the plain version of the card's stream), ids and rows byte for byte;
    the six
    GBDT-aligned KDE and random ones at ``BASE_GBDT_CPU_SCALE`` on both,
    aligned rows equal on ≥ 99%; K2 against its plain stream on the
    kronecker rows.  (b) Table 2's three methods at x4, stage times and
    ``evaluate_all``: ``random`` (``fit`` of ER, random features and the
    random aligner on the card), ``graphworld`` (SBM with phase 4b's GAN
    and the random aligner; SBM's host and card seconds) and ``ours`` (the
    asset, ``chunked=True``, K2 held as in (a)).  (c) ``ERGenerator`` at
    x64; ``sample_erdos_renyi`` at Table 8's sizes, a warm call after a
    warm-up each, and its ids at 2^20 edges equal to the CPU's.  (d) A
    KDE + random-aligner dataset at x4 by ``DatasetJob`` on the card and
    on the CPU (``cuda_prng``'s plain version), every file equal, the
    manifest's ``features`` only ``n_cont`` and ``cat_cards``; one shard
    deleted and resumed on the card, the files unchanged.  Returns the
    numbers, K2's launches on (a)-(b) and its max error."""
    import itertools
    import math
    import os
    import shutil
    import tempfile
    import numpy as np
    from repro_torch import convert
    from repro_torch.core import metrics
    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.pipeline import SyntheticGraphPipeline
    from repro_torch.data.reference import tabformer_like
    from repro_torch.datastream import DatasetJob, FeatureSpec, Manifest
    g_r, c_r, k_r = tabformer_like()
    cpu_pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                           device="cpu")
    out, walls, launches, err = {}, {}, 0, 0

    def score(g, c, k):
        m, secs = _timed(lambda: metrics.evaluate_all(g_r, c_r, k_r, g, c,
                                                      k), torch)
        check(all(math.isfinite(v) for v in m.values()),
              f"non-finite score in {m}")
        return m, secs

    # (a) Table 6's grid at x4
    t_phase = time.time()
    parts = {dev: _baseline_parts(asset_pipe, cpu_pipe, g_r, c_r, k_r, dev)
             for dev in ("cuda", "cpu")}
    walls["a_fit"] = time.time() - t_phase
    grid = {}
    for s, f, a in itertools.product(("kronecker", "sbm", "er"),
                                     ("gan", "kde", "random"),
                                     ("xgboost", "random")):
        name = f"{s}+{f}+{a}"

        def pipe_on(dev):
            p = parts[dev]
            return SyntheticGraphPipeline.fitted(
                p["struct"][s], p["features"][f], p["aligner"][a],
                asset_pipe.bipartite, device=dev)

        pipe = pipe_on("cuda")
        rs.reset_launches()
        (g, c, k), gen_s = _timed(lambda: pipe.generate(
            seed=0, scale_nodes=BASE_GRID_SCALE, chunked=True), torch)
        n_k2 = rs.LAUNCHES["rmat_sample_prng"]
        check(g.n_edges == g_r.n_edges * BASE_GRID_SCALE ** 2
              and tuple(c.shape) == (g.n_edges, c_r.shape[1])
              and tuple(k.shape) == (g.n_edges, k_r.shape[1])
              and bool(torch.isfinite(c).all()), f"grid {name}: shapes")
        m, score_s = score(g, c, k)
        row = dict(deg=m["degree_dist"], corr=m["feature_corr"],
                   joint=m["degree_feat_dist"], gen_s=gen_s,
                   score_s=score_s)
        if s == "kronecker":
            e, _ = k2_vs_plain(g, pipe.struct.scaled(BASE_GRID_SCALE), n_k2,
                               f"baselines (a) {name}", False, tr, rmat,
                               sampler, ref, rs, torch)
            check(e == 0, f"K2 disagrees on grid {name} (max {e})")
            launches, err = launches + n_k2, max(err, e)
        else:
            check(n_k2 == 0, f"grid {name}: {n_k2} K2 launches")
        def on_cpu(scale):
            # the stream the card's auto backend chose, as the CPU's
            # plain version of it
            be = sampler.resolve_backend(
                "auto", asset_pipe.struct.scaled(scale).E, "cuda").name
            return pipe_on("cpu").generate(seed=0, scale_nodes=scale,
                                           chunked=True, backend=be)

        if f != "gan" and a == "random":
            gc, cc, kc = on_cpu(BASE_GRID_SCALE)
            check(all(_same_bytes(x, y) for x, y in (
                (g.src, gc.src), (g.dst, gc.dst), (c, cc), (k, kc))),
                f"grid {name}: card and CPU bytes differ")
            row["card_eq_cpu"] = True
        elif f != "gan":
            if BASE_GBDT_CPU_SCALE != BASE_GRID_SCALE:
                g, c, k = pipe.generate(seed=0,
                                        scale_nodes=BASE_GBDT_CPU_SCALE,
                                        chunked=True)
            gc, cc, kc = on_cpu(BASE_GBDT_CPU_SCALE)
            check(_same_bytes(g.src, gc.src) and _same_bytes(g.dst, gc.dst),
                  f"grid {name}: card and CPU ids differ")
            frac = _row_frac(c, k, cc, kc, torch)
            check(frac >= 0.99, f"grid {name}: aligned rows card vs CPU "
                  f"equal on {frac:.4%}")
            row["card_vs_cpu_rows"] = frac
        grid[name] = row
        log(f"baselines (a) {name} x{BASE_GRID_SCALE}: deg "
            f"{row['deg']:.4f} corr {row['corr']:.4f} joint "
            f"{row['joint']:.4f}; generate {gen_s:.3f}s, evaluate_all "
            f"{score_s:.3f}s; card vs CPU "
            f"{row.get('card_eq_cpu', row.get('card_vs_cpu_rows', '-'))}")
        del g, c, k
    walls["a"] = time.time() - t_phase
    out["grid"] = grid

    # (b) Table 2's three methods at BASE_T2_SCALE
    t_phase = time.time()
    methods = {
        "random": SyntheticGraphPipeline(
            struct="er", features="random", aligner="random").fit(g_r, c_r,
                                                                  k_r),
        "graphworld": SyntheticGraphPipeline.fitted(
            parts["cuda"]["struct"]["sbm"], fit_pipe.features,
            RandomAligner(asset_pipe.schema), asset_pipe.bipartite),
        "ours": asset_pipe}
    table2 = {}
    for name, pipe in methods.items():
        rs.reset_launches()
        (g, c, k), wall = _timed(lambda: pipe.generate(
            seed=0, scale_nodes=BASE_T2_SCALE,
            chunked=name == "ours"), torch)
        n_k2 = rs.LAUNCHES["rmat_sample_prng"]
        tm = pipe.timings
        m, score_s = score(g, c, k)
        check(g.n_edges == g_r.n_edges * BASE_T2_SCALE ** 2,
              f"table 2 {name}: {g.n_edges} edges")
        table2[name] = dict(scores=m, score_s=score_s, wall_s=wall,
                            gen_struct_s=tm.gen_struct_s,
                            gen_feat_s=tm.gen_feat_s,
                            gen_align_s=tm.gen_align_s)
        if name == "graphworld":
            table2[name].update(sbm_host_s=pipe.struct.last_host_s,
                                sbm_card_s=tm.gen_struct_s
                                - pipe.struct.last_host_s)
        if name == "ours":
            e, _ = k2_vs_plain(g, pipe.struct.scaled(BASE_T2_SCALE), n_k2,
                               "baselines (b) ours", False, tr, rmat,
                               sampler, ref, rs, torch)
            check(e == 0, f"K2 disagrees on Table 2's ours (max {e})")
            launches, err = launches + n_k2, max(err, e)
        log(f"baselines (b) Table 2 {name} x{BASE_T2_SCALE} "
            f"({g.n_edges} edges): {json.dumps(table2[name])}")
        del g, c, k
    walls["b"] = time.time() - t_phase
    out["table2"] = table2

    # (c) ER at x64, then Table 8's sizes
    t_phase = time.time()
    er = parts["cuda"]["struct"]["er"]
    g, er_s = _timed(lambda: er.sample(np.random.default_rng(0),
                                       BASE_ER_SCALE), torch)
    check(g.n_edges == g_r.n_edges * BASE_ER_SCALE ** 2
          and int(g.src.max()) < g.n_src and int(g.dst.max()) < g.n_dst
          and int(g.src.min()) >= 0 and g.src.is_cuda,
          "ERGenerator x64: edge count or ids")
    out["er_x64"] = dict(edges=g.n_edges, s=er_s, eps=g.n_edges / er_s)
    del g
    t8 = {}
    for e in T8_EDGES:
        rmat.sample_erdos_renyi(tr.PRNGKey(0), T8_NODES, T8_NODES, e)
        (s, d), secs = _timed(lambda: rmat.sample_erdos_renyi(
            tr.PRNGKey(1), T8_NODES, T8_NODES, e), torch)
        t8[e] = dict(s=secs, eps=e / secs)
        if e == T8_CPU_EDGES:
            ws, wd = rmat.sample_erdos_renyi(tr.PRNGKey(1), T8_NODES,
                                             T8_NODES, e, device="cpu")
            check(_same_bytes(s, ws) and _same_bytes(d, wd),
                  f"sample_erdos_renyi at {e} edges: card and CPU differ")
            t8[e]["card_eq_cpu"] = True
        del s, d
    out["table8"] = t8
    log(f"baselines (c) ERGenerator x{BASE_ER_SCALE}: "
        f"{json.dumps(out['er_x64'])}; sample_erdos_renyi on "
        f"{T8_NODES} x {T8_NODES} nodes, warm: {json.dumps(t8)}")
    walls["c"] = time.time() - t_phase

    # (d) a KDE + random-aligner dataset, card against CPU, then resumed
    t_phase = time.time()
    fit = asset_pipe.struct.scaled(BASE_DS_SCALE)
    work = tempfile.mkdtemp(prefix="chip_smoke_base_")
    try:
        def job(dev):
            spec = FeatureSpec(parts[dev]["features"]["kde"],
                               RandomAligner(asset_pipe.schema))
            return DatasetJob(fit, os.path.join(work, dev),
                              shard_edges=BASE_DS_SHARD, seed=0,
                              features=spec, backend="cuda_prng",
                              device=dev)

        trees, ds_s = {}, {}
        for dev in ("cuda", "cpu"):
            _, ds_s[dev] = _timed(lambda: job(dev).run(), torch)
            trees[dev] = _tree(os.path.join(work, dev))
        check(trees["cuda"] == trees["cpu"],
              "KDE + random-aligner dataset: card and CPU files differ")
        path = os.path.join(work, "cuda")
        man = Manifest.load(path)
        want = {"n_cont": asset_pipe.schema.n_cont,
                "cat_cards": list(asset_pipe.schema.cat_cards)}
        check(man.features == want, f"manifest features {man.features}")
        check(len(man.shards) >= 2, f"{len(man.shards)} shards")
        os.remove(os.path.join(path, man.shards[1].files["cont"]))
        _, resume_s = _timed(lambda: job("cuda").resume(), torch)
        check(_tree(path) == trees["cuda"],
              "KDE + random-aligner dataset: resume changed the files")
        out["dataset"] = dict(edges=fit.E, shards=len(man.shards),
                              files=len(trees["cuda"]), card_s=ds_s["cuda"],
                              cpu_s=ds_s["cpu"], resume_s=resume_s)
        log(f"baselines (d) KDE + random aligner at x{BASE_DS_SCALE}: "
            f"{json.dumps(out['dataset'])}; card = CPU byte for byte, "
            f"manifest features {man.features}, resumed shard 1 unchanged")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    walls["d"] = time.time() - t_phase
    out.update(walls=walls, launches=launches, err=err, card=gpu_line())
    return out


#: phase 17: its wall is logged beside this budget
SCALE_BUDGET_S = 60.0
#: phase 17(c): the featured cluster's scale and shard size (640 000
#: edges in 5 shards, at least two a worker)
SCALE_FEAT_SCALE, SCALE_FEAT_SHARD = 4, 1 << 17
#: phase 17(d): the mesh step's shape (the ×64 fit's n=18 under a 2-bit
#: device prefix, m=15; 2^14 edges a device, as the CPU's plain stream
#: takes ~28 s at 2^18)
MESH_N, MESH_M, MESH_EPD = 16, 15, 1 << 14


def _shards_equal(a: str, b: str) -> bool:
    """Every shard file of dataset ``a`` equals ``b``'s, byte for byte."""
    import filecmp
    import os
    names = sorted(f for f in os.listdir(a) if f.endswith(".npy"))
    return names == sorted(f for f in os.listdir(b) if f.endswith(".npy")) \
        and all(filecmp.cmp(os.path.join(a, f), os.path.join(b, f),
                            shallow=False) for f in names)


def _sans_placement(path) -> dict:
    """The manifest without placement provenance (executor knobs, worker
    count, each shard's worker): none changes a byte of data."""
    d = _sans_executor(path)
    d.pop("num_workers", None)
    for rec in d["shards"]:
        rec.pop("worker", None)
    return d


def _worker_metrics(prefix: str, n: int) -> list:
    """The ``metrics.w{k}.json`` envelopes the cluster's workers wrote."""
    out = []
    for k in range(n):
        with open(f"{prefix}.w{k}.json") as f:
            out.append(json.load(f)["metrics"])
    return out


def _worker_split(metrics: list) -> list:
    """Each worker's stage seconds and K2 launches."""
    return [{"launches": m["launches"]["rmat_sample_prng"],
             **{k: round(m["timings"][k], 3) for k in
                ("gen_struct_s", "gen_feat_s", "gen_align_s", "write_s",
                 "wall_s")}} for m in metrics]


def phase_scaleout(path64: str, stream: dict, tr, rs, torch) -> dict:
    """Phase 17: the multi-process generation cluster on the one card.

    (a) ``repro_torch.scripts.generate_dataset``'s ``--num-workers 2``
    (this process plans and merges, two worker processes share the card)
    writes phase 13(a)'s ×64 struct-only plan: its shard files must
    equal 13(a)'s byte for byte, and its workers' K2 launches, read from
    their ``metrics.w*.json``, must sum to 13(a)'s (one a chunk).
    (b) the same through ``run_cluster`` with ``kill_after={1: 1}``: two
    rounds, worker 1 SIGKILLed after its first commit, the same bytes,
    the deep verify clean.  (c) the committed fit's GAN features and GBDT
    alignment at ×4 by a 2-worker cluster (``--asset``) equal the serial
    featured run in this process, shards and manifest bar placement.  (d)
    ``device_generate`` on a mesh of four entries on ``cuda:0`` equals the
    CPU's ids.  (e) the examples ``trillion_edge_plan`` (K2 on its
    miniature) and ``serve_batched``.  (f) ``cluster_scaling`` at its fast
    size through the runner's ``run_table``, ``byte_identical`` true.
    Returns the walls, the per-worker stage splits and K2's launches."""
    import os
    import shutil
    import tempfile

    from repro_torch import convert
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import BENCH_DIR
    from repro_torch.core import distributed_gen as dg
    import numpy as np

    from repro_torch.datastream import DatasetJob, FeatureSpec, Manifest
    from repro_torch.examples import serve_batched, trillion_edge_plan
    from repro_torch.scripts import generate_dataset as gen_cli

    work = tempfile.mkdtemp(prefix="chip_smoke_scale_")
    walls, out = {}, {}
    cwd = os.getcwd()
    try:
        # (a) the ×64 plan by two worker processes
        t0 = time.time()
        a = os.path.join(work, "cluster64")
        m_a = os.path.join(work, "a-metrics.json")
        fit64 = os.path.join(work, "fit64.json")
        with open(fit64, "w") as f:
            json.dump(stream["fit64"], f)
        flags64 = ["--fit", fit64, "--shard-edges", str(STREAM_SHARD),
                   "--seed", "0", "--num-workers", "2"]
        check(gen_cli.main(flags64 + ["--out", a, "--metrics-out", m_a])
              == 0, "17(a): the cluster failed")
        walls["a"] = round(time.time() - t0, 2)
        t1 = time.time()
        same = _shards_equal(a, path64)
        check(same, "17(a): the cluster's shards differ from 13(a)'s")
        wm = _worker_split(_worker_metrics(m_a[:-5], 2))
        launches = sum(w["launches"] for w in wm)
        check(launches == stream["launches"] and min(
            w["launches"] for w in wm) > 0,
              f"17(a): K2 launched {[w['launches'] for w in wm]} times in "
              f"the workers, {stream['launches']} in 13(a)")
        log(f"scale-out (a): 2 workers wrote 13(a)'s plan "
            f"({stream['chunks']} chunks in {stream['shards']} shards): "
            f"cluster wall {walls['a']:.2f}s (plan, two worker processes "
            f"from their start, merge) against 13(a)'s serial "
            f"{stream['wall_s']:.3f}s in-process; shards == 13(a)'s: "
            f"{same} (compared in {time.time() - t1:.2f}s); K2 launches "
            f"per worker {[w['launches'] for w in wm]} (sum {launches}); "
            f"per-worker stages {wm}")
        out["a"] = {"wall_s": walls["a"], "serial_wall_s": stream["wall_s"],
                    "workers": wm, "launches": launches}
        shutil.rmtree(a)

        # (b) kill worker 1 after its first shard
        t0 = time.time()
        b = os.path.join(work, "kill64")
        rc = gen_cli.main(flags64 + ["--out", b, "--verify"],
                          kill_after={1: 1})
        walls["b"] = round(time.time() - t0, 2)
        man = Manifest.load(b)
        check(rc == 0 and man.is_complete() and man.num_workers == 1,
              f"17(b): rc {rc} (its deep verify), complete "
              f"{man.is_complete()}, {man.num_workers} worker(s) recorded")
        same = _shards_equal(b, path64)
        check(same, "17(b): the rebalanced cluster's shards differ")
        log(f"scale-out (b): kill_after {{1: 1}}: wall {walls['b']:.2f}s "
            f"with its deep verify, two rounds (the second on the one "
            f"survivor's stripe count), shards == 13(a)'s: {same}")
        out["b"] = {"wall_s": walls["b"]}
        shutil.rmtree(b)

        # (c) features and alignment: cluster against serial
        t0 = time.time()
        pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                           device="cuda")
        fit4 = pipe.struct.scaled(SCALE_FEAT_SCALE)
        serial = os.path.join(work, "feat4-serial")
        job = DatasetJob(fit4, serial, shard_edges=SCALE_FEAT_SHARD, seed=0,
                         features=FeatureSpec(pipe.features, pipe.aligner))
        job.run()
        walls["c_serial"] = round(time.time() - t0, 2)
        del pipe
        t0 = time.time()
        c = os.path.join(work, "feat4-cluster")
        m_c = os.path.join(work, "c-metrics.json")
        check(gen_cli.main(["--asset", str(ASSET), "--scale-nodes",
                            str(SCALE_FEAT_SCALE), "--shard-edges",
                            str(SCALE_FEAT_SHARD), "--seed", "0", "--out", c,
                            "--num-workers", "2", "--metrics-out", m_c])
              == 0, "17(c): the featured cluster failed")
        walls["c"] = round(time.time() - t0, 2)
        same = _shards_equal(c, serial)
        manif = _sans_placement(c) == _sans_placement(serial)
        wc = _worker_split(_worker_metrics(m_c[:-5], 2))
        check(same and manif and len(job.scheduler.shards) >= 4,
              f"17(c): featured cluster shards equal {same}, manifests "
              f"equal bar placement {manif}")
        log(f"scale-out (c): featured x{SCALE_FEAT_SCALE} (E={fit4.E}, "
            f"{len(job.scheduler.shards)} shards): serial "
            f"{walls['c_serial']:.2f}s (load + run), cluster "
            f"{walls['c']:.2f}s; shards and manifest (bar placement) equal: "
            f"{same and manif}; per-worker stages {wc}")
        out["c"] = {"wall_s": walls["c"], "serial_wall_s": walls["c_serial"],
                    "workers": wc}

        # (d) the mesh step on one card
        t0 = time.time()
        th = np.random.default_rng(0).dirichlet(np.ones(4), MESH_N + 2)
        seeds = dg.step_seeds(0, 1, 4)
        got = dg.device_generate(th, seeds, MESH_N, MESH_M, MESH_EPD,
                                 mesh=["cuda:0"] * 4)
        want = dg.device_generate(th, seeds, MESH_N, MESH_M, MESH_EPD,
                                  mesh=["cpu"] * 4)
        same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
        prefixes = [sorted(set((got[0][i] >> MESH_N).cpu().tolist()))
                    for i in range(4)]
        check(same and prefixes == [[0], [1], [2], [3]],
              f"17(d): mesh ids equal {same}, prefixes {prefixes}")
        walls["d"] = round(time.time() - t0, 2)
        log(f"scale-out (d): device_generate over 4 x cuda:0 (n={MESH_N} "
            f"under a 2-bit prefix, m={MESH_M}, {MESH_EPD} edges a device) "
            f"== the CPU's: {same}; prefixes {prefixes}")

        # (e) the examples
        t0 = time.time()
        rs.reset_launches()
        ex = trillion_edge_plan.main(device="cuda")
        k2 = rs.LAUNCHES["rmat_sample_prng"]
        check(k2 == 16 and int(ex["sizes"].sum()) == 10 ** 12
              and np.abs(ex["theta"] - DEMO_THETA).max() < 0.01,
              f"17(e): trillion_edge_plan: K2 {k2}, theta {ex['theta']}")
        walls["e_trillion"] = round(time.time() - t0, 2)
        t0 = time.time()
        served = serve_batched.main(device="cuda")
        check(sorted(served["out"]) == list(range(10))
              and served["tokens"] == 160, "17(e): serve_batched")
        walls["e_serve"] = round(time.time() - t0, 2)
        log(f"scale-out (e): trillion_edge_plan {walls['e_trillion']:.2f}s "
            f"(K2 {k2} launches on the miniature, theta "
            f"{np.round(ex['theta'], 4).tolist()}); serve_batched "
            f"{walls['e_serve']:.2f}s, {served['tokens']} tokens in "
            f"{served['seconds']:.3f}s")
        out["e"] = {"k2": k2, "theta": ex["theta"].tolist(),
                    "serve_s": served["seconds"]}

        # (f) the benchmark at its fast size
        t0 = time.time()
        os.chdir(work)
        res = bench_run.run_table("cluster_scaling", True, "cuda")
        walls["f"] = round(time.time() - t0, 2)
        check(res["byte_identical"] is True,
              f"17(f): cluster_scaling: {res}")
        with open(os.path.join(BENCH_DIR, "BENCH_cluster.json")) as f:
            env = json.load(f)["env"]
        card = gpu_line()
        check(env["card"] == torch.cuda.get_device_name(0)
              and env["power_limit"] == card.rsplit(",", 1)[1].strip(),
              f"17(f): BENCH_cluster.json names {env['card']!r}, "
              f"{env['power_limit']!r}, not {card!r}")
        log(f"scale-out (f): cluster_scaling fast ({res['edges']} edges): "
            f"serial {res['serial']['seconds']:.2f}s, 2 workers "
            f"{res['cluster2']['seconds']:.2f}s, speedup "
            f"{res['speedup']:.3f}, byte_identical {res['byte_identical']}")
        out["f"] = {k: res[k] for k in ("serial", "cluster2", "speedup",
                                        "byte_identical")}
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    out.update(walls=walls, wall=round(sum(walls.values()), 2),
               launches=out["a"]["launches"], card=gpu_line())
    return out


#: phase 16 runs the runner's tables at their fast sizes, but these
#: five: phases 4, 14 and 15 drive their paths through library calls, and
#: each of their GAN fits takes ~10 s; phase 17(f) runs
#: ``cluster_scaling``; phase 21 makes ``roofline``'s tables from its own
#: dry-run cells
BENCH_SKIP = ("table2_quality", "table5_scale_metrics", "table6_ablation",
              "cluster_scaling", "roofline")
#: phase 16's wall, seconds
BENCH_BUDGET_S = 60.0
#: the row names of the tables that return rows, at fast sizes
BENCH_ROWS = {
    "fig2_distributions": [f"fig2/{v}" for v in ("original", "ours",
                                                  "random", "graphworld")],
    "table3_scaling": [f"table3/scale{k}x" for k in (1, 2, 4)],
    "table8_er_timings": [f"table8/er_{e}" for e in (1 << 18, 1 << 20,
                                                      1 << 22)],
    "table10_structural_stats": [f"table10/{v}" for v in (
        "original", "ours_no_noise", "ours_noise", "rmat_default")],
    "fig8_throughput": ["fig8/reference", "fig8/cuda_bits", "fig8/cuda_prng",
                        "fig8/h100_kernel_bits_bound",
                        "fig8/h100_kernel_prng_bound"],
    "gnn_throughput": [f"gnn/{k}/{v}" for k in ("gcn", "gat")
                       for v in ("original", "ours", "random")],
}
#: the result keys of the tables that return a dict
BENCH_KEYS = {
    "datastream_throughput": {"edges", "shard_edges", "overlap_speedup",
                              "double_buffered", "serial"},
    "feature_throughput": {"rows", "reference_rows", "batch", "decode",
                           "gan_sample", "gbdt_predict", "align"},
    "executor_overlap": {"edges", "shard_edges", "smoke", "configs",
                         "serial_nofeat", "pipelined_nofeat",
                         "speedup_nofeat", "serial_feat", "pipelined_feat",
                         "speedup_feat", "fused_vs_staged", "write_path"},
    "fit_throughput": {"rows", "shard_edges", "device", "streamed_fit",
                       "inmemory_fit", "theta_delta", "slowdown",
                       "bitpair_mle", "degree_sketch", "reservoir"},
}


def _finite_numbers(label: str, x) -> None:
    """Every number in a table's result is finite."""
    import math
    if isinstance(x, dict):
        for k, v in x.items():
            _finite_numbers(f"{label}.{k}", v)
    elif isinstance(x, (int, float)) and not isinstance(x, bool):
        check(math.isfinite(x), f"{label} is {x}")


def _row_fields(r: dict) -> dict:
    """A row's derived ``k=v;...`` fields as numbers (a bound row's note
    after its number dropped)."""
    out = {}
    for kv in r["derived"].split(";"):
        k, v = kv.split("=", 1)
        out[k] = float(v.split()[0])
    return out


def phase_benchmarks(trace_path: str, tr, sampler, rs, torch) -> dict:
    """Phase 16: the benchmark tables (``repro_torch.benchmarks``) on the
    card, each through the runner's ``run_table`` at its fast size, but
    ``BENCH_SKIP``; K1 and K2 counted (reset first) over the tables.

    Every table's rows carry the expected names (``BENCH_ROWS``) or
    result keys (``BENCH_KEYS``) and finite numbers; Fig. 8 times all
    three backends, each at most its H100 bound (a larger share would mean
    a timed call did not end on the device); Fig. 8's ``cuda_bits`` and
    ``cuda_prng`` ids for its key and sizes equal the plain version of
    their stream on the CPU, and each other; every ``BENCH_*.json``
    names the card and its power limit.  Then ``report_run`` and
    ``obs.export`` read phase 13(c)'s traced CLI run: a stage breakdown,
    and a Chrome trace with at least two thread lanes.  The tables write
    into a temporary directory that is removed."""
    import glob
    import os
    import shutil
    import tempfile

    from repro_torch.benchmarks import fig8_throughput as fig8
    from repro_torch.benchmarks import run as bench_run
    from repro_torch.benchmarks.common import BENCH_DIR
    from repro_torch.obs.sinks import load_events
    from repro_torch.scripts import report_run

    card = gpu_line()
    work = tempfile.mkdtemp(prefix="chip_smoke_bench_")
    cwd = os.getcwd()
    walls, out = {}, {}
    try:
        os.chdir(work)
        rs.reset_launches()
        for name in bench_run.TABLES:
            if name in BENCH_SKIP:
                continue
            t0 = time.time()
            res = bench_run.run_table(name, True, "cuda")
            torch.cuda.synchronize()
            walls[name] = round(time.time() - t0, 2)
            if name in BENCH_ROWS:
                check([r["name"] for r in res] == BENCH_ROWS[name],
                      f"{name}: rows {[r['name'] for r in res]}")
                for r in res:
                    _finite_numbers(r["name"], r["us_per_call"])
                    _finite_numbers(r["name"], _row_fields(r))
                out[name] = {r["name"]: [r["us_per_call"], r["derived"]]
                             for r in res}
            else:
                check(set(res) == BENCH_KEYS[name],
                      f"{name}: keys {sorted(res)}")
                _finite_numbers(name, res)
                out[name] = res
        launches = {k: rs.LAUNCHES[k] for k in ("rmat_sample_bits",
                                                "rmat_sample_prng")}
        check(all(launches.values()),
              f"benchmarks: a kernel never launched: {launches}")
        for name in ("reference", "cuda_bits", "cuda_prng"):
            f = _row_fields({"derived": out["fig8_throughput"][
                f"fig8/{name}"][1]})
            check(0 < f["of_bound"] <= 1.0,
                  f"fig8/{name} at {f['of_bound']} of its H100 bound")

        # the timed backends' ids: the plain version of their stream
        th, L = fig8.thetas(), fig8.N_LEVELS
        err = 0
        for name in ("cuda_bits", "cuda_prng"):
            E = fig8.E_FAST[name]
            got = sampler.get_backend(name).sample(tr.PRNGKey(1), th, L, L,
                                                   E, device="cuda")
            want = sampler.get_backend("cuda_bits").sample(
                tr.PRNGKey(1), th, L, L, E, device="cpu")
            for a, b in zip(got, want):
                err = max(err, int((a.cpu().to(torch.int64)
                                    - b.to(torch.int64)).abs().max()))
            if name == "cuda_bits":
                other = sampler.get_backend("cuda_prng").sample(
                    tr.PRNGKey(1), th, L, L, E, device="cuda")
                check(all(torch.equal(a, b) for a, b in zip(got, other)),
                      "fig8: cuda_prng's ids differ from cuda_bits'")
        check(err == 0, f"fig8: the kernels' ids are {err} off the plain "
              "version's")

        envelopes = sorted(glob.glob(os.path.join(BENCH_DIR, "BENCH_*.json")))
        limit = card.rsplit(",", 1)[1].strip()
        for path in envelopes:
            with open(path) as f:
                env = json.load(f)["env"]
            check(env["card"] == torch.cuda.get_device_name(0)
                  and env["power_limit"] == limit,
                  f"{os.path.basename(path)} names {env['card']!r}, "
                  f"{env['power_limit']!r}, not {card!r}")
        check(len(envelopes) == 5, f"envelopes: {envelopes}")

        events = load_events(trace_path)
        rep = report_run.summarize(events)
        check(rep["n_spans"] > 0 and rep["wall_s"] > 0
              and rep["stage_s"]["struct"] > 0 and rep["stage_s"]["write"] > 0,
              f"report_run on the traced CLI run: {rep}")
        chrome = os.path.join(work, "trace.chrome.json")
        check(report_run.main([trace_path, "--perfetto", chrome]) == 0,
              "report_run --perfetto")
        with open(chrome) as f:
            written = json.load(f)["traceEvents"]
        lanes = sorted({e["args"]["name"] for e in written
                        if e.get("name") == "thread_name"})
        spans = {e["tid"] for e in written if e["ph"] == "X"}
        check(len(lanes) >= 2 and len(spans) >= 2,
              f"the Chrome trace has lanes {lanes}, spans on {spans}")
    finally:
        os.chdir(cwd)
        shutil.rmtree(work, ignore_errors=True)
    return {"walls": walls, "wall": round(sum(walls.values()), 2),
            "launches": launches, "err": err, "tables": out,
            "report": {k: rep[k] for k in ("n_spans", "wall_s", "busy_s",
                                           "overlap", "stage_s", "stall")},
            "lanes": lanes, "envelopes": len(envelopes), "card": card}


def attn_err(got, want) -> float:
    return (got.float() - want.float()).abs().max().item()


def flash_inputs(hq, hkv, s, d, dtype, seed, torch):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=gen).to("cuda", dtype)
            for shape in ((hq, s, d), (hkv, s, d), (hkv, s, d))]


#: V's scale in phase 8's early-row check: early causal rows then reach
#: |out| of 4–32, where one bf16 step is 2^-5–2^-3
V_SCALE = 8.0


def early_row_excess(got, want, v_scale: float = V_SCALE) -> float:
    """max |got − want| over its limit: one bf16 step at |want|,
    ``2**(floor(log2|want|) − 7)``, where |want| ≥ 4; elsewhere 2e-2
    times the V scale (attention is linear in V).  At most 1 passes."""
    import torch
    got, want = got.float(), want.float()
    a = want.abs()
    step = torch.exp2(torch.floor(torch.log2(a.clamp_min(4.0))) - 7)
    limit = torch.where(a >= 4, step, torch.full_like(a, 2e-2 * v_scale))
    return ((got - want).abs() / limit).max().item()


def phase_early_rows(fa, ref, torch) -> dict:
    """The tensor-core route on early causal rows of outputs ≥ 4: bf16
    inputs with V scaled by ``V_SCALE``, Hq 16, Hkv 4, S = T in {256,
    2048}, d in {64, 128}, against the plain version on float32 copies of
    the same bf16 inputs, to ``early_row_excess``'s limits.  SDPA's
    reading on the same inputs is logged beside it, not held.  Returns
    the largest excess of each."""
    F = torch.nn.functional
    worst = {"kernel": 0.0, "sdpa": 0.0}
    for s_, d_ in ((256, 64), (256, 128), (2048, 64), (2048, 128)):
        q, k, v = flash_inputs(16, 4, s_, d_, torch.bfloat16, 3 * s_ + d_,
                               torch)
        v = v * V_SCALE
        want = ref.attention_ref(q.float(), k.float(), v.float(),
                                 causal=True, group=4)
        fa.reset_launches()
        got = fa.flash_attention(q, k, v, causal=True, group=4)
        torch.cuda.synchronize()
        launches = fa.LAUNCHES["flash_attention_wgmma"]
        sdpa = F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True,
                                              enable_gqa=True)[0]
        got_x, sdpa_x = early_row_excess(got, want), early_row_excess(sdpa,
                                                                      want)
        big = int((want.abs() >= 4).sum())
        early = float(want[:, :16].abs().max())
        log(f"flash early rows Hq=16 Hkv=4 S=T={s_} d={d_} causal bf16, V x "
            f"{V_SCALE:g}: {big} outputs with |want| >= 4 (max |want| on "
            f"rows 0-15 {early:.3f}); max |err| / limit: kernel "
            f"{got_x:.4f}, sdpa {sdpa_x:.4f} (limit 1: one bf16 step where "
            f"|want| >= 4, {2e-2 * V_SCALE:g} elsewhere)")
        check(launches == 1, "the early-row check left the tensor-core "
              f"route ({launches} launches)")
        check(early >= 4, "no early causal output reached 4")
        check(got_x <= 1.0, "flash_attention misses the early-row limit "
              f"({got_x:.4f} of it)")
        worst = {"kernel": max(worst["kernel"], got_x),
                 "sdpa": max(worst["sdpa"], sdpa_x)}
        del q, k, v, want, got, sdpa
    torch.cuda.empty_cache()
    return worst


def phase_flash_kernel(fa, ref, torch) -> tuple:
    """K4 against its plain version, each call on the route its dtype and
    head dim select (checked on the per-route counters), then on early
    causal rows (``phase_early_rows``).  Returns the max error of the
    tensor-core route (bf16), of the FMA route in f32, and the early-row
    readings."""
    tol = {torch.bfloat16: 2e-2, torch.float32: 2e-5}
    hq, hkv, s, d = (FLASH_PATH[k] for k in ("hq", "hkv", "s", "d"))
    bf, f32 = torch.bfloat16, torch.float32
    routes = ("wgmma", "fma")
    errs = {}
    # Hq, Hkv, S = T, d, causal, dtype, blk (the Pallas blocks; 8 lets a
    # ragged S through the wrapper's check), route
    for hq_, hkv_, s_, d_, causal, dtype, blk, want_route in (
            (hq, hkv, s, d, True, bf, 128, "wgmma"),
            (64, 16, 2048, 128, True, bf, 128, "wgmma"),
            (32, 4, 1024, 64, False, bf, 128, "wgmma"),
            (64, 4, 2048, 64, True, bf, 128, "wgmma"),
            (64, 4, 2048, 128, True, bf, 128, "wgmma"),
            (16, 4, 1000, 64, True, bf, 8, "wgmma"),
            (16, 4, 1000, 128, False, bf, 8, "wgmma"),
            (hq, hkv, s, d, True, f32, 128, "fma"),
            (32, 4, 1024, 32, True, bf, 128, "fma")):
        q, k, v = flash_inputs(hq_, hkv_, s_, d_, dtype, s_ + d_, torch)
        fa.reset_launches()
        got = fa.flash_attention(q, k, v, causal=causal, group=hq_ // hkv_,
                                 blk_q=blk, blk_k=blk)
        torch.cuda.synchronize()
        route_launches = {r: fa.LAUNCHES[f"flash_attention_{r}"]
                          for r in routes}
        want = ref.attention_ref(q, k, v, causal=causal, group=hq_ // hkv_)
        err = attn_err(got, want)
        log(f"flash kernel Hq={hq_} Hkv={hkv_} S=T={s_} d={d_} "
            f"causal={causal} {dtype}: route {want_route} (launches "
            f"{route_launches}), max|kernel - plain| {err:.3g} (limit "
            f"{tol[dtype]:g})")
        check(route_launches == {r: int(r == want_route) for r in routes},
              f"flash_attention took the wrong route: {route_launches}")
        check(err < tol[dtype], "flash_attention disagrees with "
              f"attention_ref ({err:.3g})")
        errs[want_route, dtype] = max(errs.get((want_route, dtype), 0.0),
                                      err)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return errs["wgmma", bf], errs["fma", f32], phase_early_rows(fa, ref,
                                                                 torch)


@contextlib.contextmanager
def first_flash_inputs(fa):
    """Within the block, ``flash_attention`` keeps its first call's
    inputs (layer 0's q, k, v and keywords) in the list it yields."""
    first = []
    plain_call = fa.flash_attention

    def capture(q, k, v, **kw):
        if not first:
            first.append((q, k, v, kw))
        return plain_call(q, k, v, **kw)

    fa.flash_attention = capture
    try:
        yield first
    finally:
        fa.flash_attention = plain_call


def phase_lm_scoring(tr, get_config, Model, transformer, fa, rs, ref,
                     torch):
    """Scoring at full width through the flash path, then the same forward
    on the einsum path.  Returns (params, K4 launches, K4's max error on
    the first layer's own q/k/v)."""
    cfg = get_config(LM_ARCH).replace(attn_impl="flash")
    model = Model(cfg, "cuda")
    t0 = time.time()
    params = model.init_params(tr.PRNGKey(0))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in params.parameters())
    log(f"lm: {cfg.name} L={cfg.n_layers} d={cfg.d_model} H={cfg.n_heads} "
        f"KV={cfg.n_kv_heads} Hd={cfg.resolved_head_dim} ff={cfg.d_ff} "
        f"V={cfg.vocab} {cfg.dtype}: {n_params} parameters "
        f"({n_params * 2 / 1e9:.2f} GB) drawn in {time.time() - t0:.2f}s; "
        "depth and widths not cut")
    toks = tr.randint(tr.PRNGKey(1), (LM_B, LM_S), 0, cfg.vocab, "cuda")
    batch = {"tokens": toks, "labels": toks}

    with first_flash_inputs(fa) as first:
        torch.cuda.synchronize()
        rs.reset_launches()
        fa.reset_launches()
        t0 = time.time()
        logits = model.forward(params, batch).logits
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fa.LAUNCHES["flash_attention"]
        tc_launches = fa.LAUNCHES["flash_attention_wgmma"]
    loss = transformer.loss_from_logits(logits, batch, cfg).item()
    check(tuple(logits.shape) == (LM_B, LM_S, cfg.vocab), "logits shape")
    check(bool(torch.isfinite(logits).all()) and loss == loss
          and abs(loss) != float("inf"), "non-finite logits or loss")
    check(launches == tc_launches == cfg.n_layers,
          f"{launches} flash launches ({tc_launches} on the tensor-core "
          f"route) on one forward, not {cfg.n_layers}")
    check(sum(rs.LAUNCHES.values()) == 0, "R-MAT kernels ran in scoring")
    t0 = time.time()
    model.forward(params, batch)
    torch.cuda.synchronize()
    wall2 = time.time() - t0
    log(f"lm scoring: B={LM_B} S={LM_S} flash forward {wall * 1e3:.1f} ms "
        f"(first), {wall2 * 1e3:.1f} ms (second); "
        f"{LM_B * LM_S / wall2:.1f} tokens/s; loss {loss:.6f}; "
        f"flash launches {launches}, {tc_launches} on the tensor-core route")

    q, k, v, kw = first[0]
    err = attn_err(fa.flash_attention(q, k, v, **kw),
                   ref.attention_ref(q, k, v, causal=kw["causal"],
                                     group=kw["group"]))
    log(f"lm scoring: layer 0's own q {tuple(q.shape)} k {tuple(k.shape)}: "
        f"max|kernel - plain| {err:.3g}")
    check(err < 2e-2, f"flash_attention disagrees on the path ({err:.3g})")
    del first, q, k, v

    einsum = Model(cfg.replace(attn_impl="einsum"), "cuda")
    fa.reset_launches()
    t0 = time.time()
    logits_e = einsum.forward(params, batch).logits
    torch.cuda.synchronize()
    wall_e = time.time() - t0
    loss_e = transformer.loss_from_logits(logits_e, batch, cfg).item()
    dlogit = attn_err(logits, logits_e)
    log(f"lm scoring: einsum forward {wall_e * 1e3:.1f} ms, loss "
        f"{loss_e:.6f}; |loss diff| {abs(loss - loss_e):.3g}, max |logit "
        f"diff| {dlogit:.3g}; flash launches {fa.LAUNCHES['flash_attention']}")
    check(fa.LAUNCHES["flash_attention"] == 0, "einsum path ran the kernel")
    check(abs(loss - loss_e) < 2e-2, "flash and einsum losses differ")
    del logits, logits_e
    torch.cuda.empty_cache()
    return model, params, launches, err


def busy_us(intervals) -> float:
    """Length of the union of ``(start, end)`` intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total


#: host calls the traces count as kernel launches and as memcpy/syncs
LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
                "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaMemcpy",
              "cudaMemcpyAsync")


def call_sites(events, names, top: int = 8) -> list:
    """``(site, count)`` of the host ``events`` named in ``names``, by the
    outermost operator above each (``aten::to`` for a host tensor sent to
    the card, ``aten::item`` for a value read back, ...) and the call."""
    counts = {}
    for e in events:
        if e.name not in names:
            continue
        outer, p = None, e.cpu_parent
        while p is not None:
            outer, p = p, p.cpu_parent
        site = f"{'no operator' if outer is None else outer.name} > {e.name}"
        counts[site] = counts.get(site, 0) + 1
    return sorted(counts.items(), key=lambda kv: -kv[1])[:top]


def trace_steps(label: str, run, steps: int, torch) -> dict:
    """Where a step's time goes: ``run()`` (``steps`` steps, then a
    synchronize) under ``torch.profiler``: kernel launches, host-device
    syncs (the closing synchronize not counted), device busy time and
    idle share per step, the top device operations, and the memcpy/sync
    calls by the operator that made them."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    device = [e for e in events if e.device_type == DeviceType.CUDA]
    host = [e.name for e in events if e.device_type == DeviceType.CPU]
    launches = sum(n in LAUNCH_CALLS for n in host)
    syncs = sum(n in SYNC_CALLS for n in host) - 1
    if not device:
        log(f"{label} trace: the profiler saw no device operations; busy "
            "time and idle share not measured")
        return {}
    busy = busy_us((e.time_range.start, e.time_range.end)
                   for e in device) / 1e6
    by_name = {}
    for e in device:
        c, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (c + 1, t + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]
    out = {"wall_ms": wall / steps * 1e3,
           "device_ops": len(device) / steps, "launches": launches / steps,
           "syncs": syncs / steps, "busy_ms": busy / steps * 1e3,
           "idle_share": 1 - busy / wall}
    log(f"{label} trace: {steps} steps, traced wall "
        f"{out['wall_ms']:.3f} ms per step; per step "
        f"{out['device_ops']:.1f} device operations, "
        f"{out['launches']:.1f} kernel launches, {out['syncs']:.2f} "
        f"memcpy/sync calls, device busy {out['busy_ms']:.3f} ms; "
        f"device idle share {out['idle_share']:.4f}; top device operations "
        f"(count, us per step): " + "; ".join(
            f"{name[:60]} {c / steps:.0f} {t / steps:.1f}"
            for name, (c, t) in top))
    sites = call_sites(events, SYNC_CALLS)
    log(f"{label} trace: memcpy/sync calls per step by operator: "
        + "; ".join(f"{site} {c / steps:.2f}" for site, c in sites))
    return out


def trace_decode(eng, torch, steps: int = 4) -> None:
    """``steps`` steps of the engine's fixed-shape decode (all 4 slots at
    position 300), after one untraced step."""
    import numpy as np
    cur = np.zeros((eng.B, 1), np.int32)
    pos = np.full((eng.B, 1), 300, np.int32)
    eng._decode(cur, pos)

    def run():
        for _ in range(steps):
            eng._decode(cur, pos)

    trace_steps("serving", run, steps, torch)


def timed_engine(ServingEngine):
    """``ServingEngine`` that sums its decode steps' host seconds (each
    step ends on the host) and keeps a copy of each slot's cache as a
    prefill found it (``found``, in admission order)."""

    class TimedEngine(ServingEngine):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.decode_s, self.decode_steps, self.found = 0.0, 0, []

        def _decode(self, tokens, positions):
            t0 = time.perf_counter()
            out = super()._decode(tokens, positions)
            self.decode_s += time.perf_counter() - t0
            self.decode_steps += 1
            return out

        def _prefill_slot(self, tokens, slot):
            self.found.append({k: c[:, slot:slot + 1].clone()
                               for k, c in self.cache.items() if k != "pos"})
            return super()._prefill_slot(tokens, slot)

    return TimedEngine


def phase_serving(model, params, ServingEngine, Request, fa, torch):
    """The engine at full width: 8 requests through 4 slots."""
    import numpy as np

    TimedEngine = timed_engine(ServingEngine)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, model.cfg.vocab, size=int(n), dtype=np.int32)
               for n in rng.integers(16, 257, size=8)]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TimedEngine(model, params, max_batch=4, max_len=512)
    fa.reset_launches()
    t0 = time.time()
    out = eng.run([Request(i, p, max_new=32) for i, p in enumerate(prompts)])
    wall = time.time() - t0
    launches = fa.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(sorted(out) == list(range(len(prompts))), "requests unanswered")
    check(all(len(v) == 32 for v in out.values()), "short answers")
    check(launches == 0, "the engine's cache path ran the flash kernel")
    decode_tokens = sum(len(v) - 1 for v in out.values())
    log(f"serving: {len(prompts)} requests, prompts "
        f"{[len(p) for p in prompts]}, max_new=32, 4 slots, max_len=512: "
        f"wall {wall:.3f}s; {eng.decode_steps} decode steps in "
        f"{eng.decode_s:.3f}s, {decode_tokens / eng.decode_s:.1f} decode "
        f"tokens/s; peak device memory {peak:.2f} GB; flash launches "
        f"{launches}")
    trace_decode(eng, torch)
    with torch.no_grad():
        for i, p in enumerate(prompts):
            cache = model.init_cache(1, 512)
            logits, _ = model.prefill(
                params, {"tokens": torch.from_numpy(p)[None].cuda()}, cache)
            first = int(torch.argmax(logits[0].float()))
            check(first == out[i][0], f"request {i}: first token {out[i][0]}"
                  f" but prefill alone gives {first}")
    log("serving: every first token equals Model.prefill of its prompt "
        "alone")


#: phase 18: its wall is logged beside this budget
TRAIN_BUDGET_S = 45.0
#: phase 18(a): tinyllama-1.1b's training batch, steps and warmup
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_WARMUP = 8, 2048, 6, 2
#: phase 18(b): card against CPU, float32 at the smoke width: losses
#: within 1e-4; masters within 5e-5, a tenth of the lr (Adam's first
#: update lr·g/(|g| + 1e-8) turns last-bit gradient differences of weights
#: whose gradient is near 1e-8 into a part of lr)
CARD_CPU_LOSS_TOL, CARD_CPU_MASTER_TOL = 1e-4, 5e-5
#: phase 18(d): the fifth example's steps (300 by default), a depth cut for
#: the phase's wall (100 steps took 14.9 s, most of it ~84 ms steps)
EXAMPLE_STEPS = 50


def watch_first_step(trainer) -> dict:
    """Wraps ``trainer.step_fn``; after the first step the dict returned
    holds, per leaf, whether its master left the weight it started from
    (``moved``) and whether its first moment is nonzero (``mu``): no
    gradient was cut."""
    from repro_torch.models.params import leaves
    inner, first = trainer.step_fn, {}

    def step_fn(params, opt_state, batch):
        if first:
            return inner(params, opt_state, batch)
        before = [w.detach().clone() for w in leaves(params.tree())]
        params, opt_state, m = inner(params, opt_state, batch)
        first.update(moved=[bool((m != w.float()).any()) for w, m in
                            zip(before, leaves(opt_state.master))],
                     mu=[bool(mu.any()) for mu in leaves(opt_state.mu)])
        return params, opt_state, m

    trainer.step_fn = step_fn
    return first


def k2_unchunked_vs_plain(g, fit, label: str, tr, rmat, sampler, ref, rs,
                          torch) -> int:
    """K2 at the shape ``generate(seed=0)`` (unchunked) of ``fit`` gave
    it, with the run's own per-level θ: the kernel and the run's edges
    against the plain stream.  Returns the max error."""
    import numpy as np
    thetas = rmat.derive_thetas(fit, rng=np.random.default_rng(0))
    th = torch.tensor(thetas, dtype=torch.float32, device="cuda")
    E = fit.E
    pad = sampler._pad_edges(E, sampler.choose_block(E))
    key = tr.PRNGKey(0)
    want = ref.rmat_prng_ref(key, th, fit.n, fit.m, E, pad)
    e_kern = max_word_err(rs.rmat_sample_prng(key, th, fit.n, fit.m, E, pad),
                          want)
    e_run = max(int((g.src.to(torch.int64) - want[0].lo).abs().max()),
                int((g.dst.to(torch.int64) - want[1].lo).abs().max()))
    log(f"{label}: K2 at n={fit.n} m={fit.m} E={E} stride={pad}, per-level "
        f"θ: max|err| prng-vs-plain={e_kern} run-vs-plain={e_run}")
    return max(e_kern, e_run)


def phase_training(convert, tr, rmat, sampler, ref, rs, fa, get_config,
                   Model, torch) -> dict:
    """Training: (a) full-width tinyllama-1.1b on a walk corpus over the
    asset's x1 graph, (b) the train step card against CPU, (c) checkpoint,
    resume and fault recovery at the fifth example's width, (d) the fifth
    example in-process.  Returns the phase's numbers, K2's launches on its
    path and K2's max error at the shapes that path gave it."""
    import numpy as np
    import os
    import shutil
    import tempfile
    from repro_torch.data.pipeline import GraphWalkCorpus, SyntheticTokens
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.examples import train_lm_on_graph_corpus as example
    from repro_torch.kernels.bounds import PEAK_FLOPS
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.models.transformer import DenseLM
    from repro_torch.training import optimizer as opt
    from repro_torch.training.steps import make_train_step
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from repro_torch.utils import tree_size

    out, walls = {}, {}
    card = gpu_line()
    work = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        # (a) full width: the corpus over the asset's x1 generate (K2)
        t0 = time.time()
        pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                           device="cuda")
        rs.reset_launches()
        g, _, _ = pipe.generate(seed=0)
        torch.cuda.synchronize()
        k2 = rs.LAUNCHES["rmat_sample_prng"]
        check(k2 > 0, "18(a): the x1 generate never ran K2")
        err = k2_unchunked_vs_plain(g, pipe.struct.scaled(1), "18(a) corpus",
                                    tr, rmat, sampler, ref, rs, torch)
        cfg = get_config(LM_ARCH).replace(attn_impl="einsum", remat=True,
                                          remat_policy="nothing")
        check(cfg.microbatches == 2, f"{LM_ARCH}: microbatches "
              f"{cfg.microbatches}, not its config's 2")
        corpus = GraphWalkCorpus(g, vocab=cfg.vocab)
        model = Model(cfg, "cuda")
        n_params = tree_size(model.abstract_params())
        trainer = Trainer(model, opt.OptConfig(warmup_steps=TRAIN_WARMUP,
                                               total_steps=TRAIN_STEPS),
                          TrainerConfig(total_steps=TRAIN_STEPS,
                                        log_every=1000))
        first = watch_first_step(trainer)
        walls["a_setup"] = time.time() - t0
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        fa.reset_launches()
        t0 = time.time()
        params, opt_state = trainer.fit(tr.PRNGKey(0),
                                        corpus.batches(TRAIN_B, TRAIN_S))
        torch.cuda.synchronize()
        walls["a_train"] = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        hist = trainer.history
        check(len(hist) == TRAIN_STEPS, f"18(a): {len(hist)} steps")
        check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
                  and h["grad_norm"] > 0 for h in hist),
              f"18(a): a loss or grad norm not finite and positive: {hist}")
        check(all(first["moved"]) and all(first["mu"]),
              f"18(a): after step 1, masters moved {first['moved']}, "
              f"first moments nonzero {first['mu']}")
        check(fa.LAUNCHES["flash_attention"] == 0,
              "18(a): the einsum path ran the flash kernel")
        check(int(opt_state.step) == TRAIN_STEPS, "18(a): the step count")
        step_s = float(np.median([h["dt"] for h in hist[1:]]))
        tokens = TRAIN_B * TRAIN_S
        flops = 8 * n_params * tokens     # 6N per token, +2N remat forward
        out["a"] = {
            "params": n_params, "B": TRAIN_B, "S": TRAIN_S,
            "microbatches": cfg.microbatches, "remat": cfg.remat_policy,
            "steps": TRAIN_STEPS,
            "loss": [h["loss"] for h in hist],
            "grad_norm": [h["grad_norm"] for h in hist],
            "step_ms": [h["dt"] * 1e3 for h in hist],
            "step_ms_median_2_on": step_s * 1e3,
            "tokens_per_s": tokens / step_s,
            "model_flops_share": flops / step_s / PEAK_FLOPS["bfloat16"],
            "peak_mem_GB": peak, "card": card}
        log(f"training (a): {cfg.name} L={cfg.n_layers} d={cfg.d_model} "
            f"{n_params} params {cfg.dtype}, B={TRAIN_B} x S={TRAIN_S} in "
            f"{cfg.microbatches} microbatches, remat {cfg.remat_policy!r}, "
            f"einsum attention, {TRAIN_STEPS} steps: losses "
            f"{[round(h['loss'], 4) for h in hist]}, grad norms "
            f"{[round(h['grad_norm'], 4) for h in hist]}; step ms "
            f"{[round(h['dt'] * 1e3, 1) for h in hist]} (median of 2-"
            f"{TRAIN_STEPS} {step_s * 1e3:.1f}), {tokens / step_s:.0f} "
            f"tokens/s, model-FLOPs share {out['a']['model_flops_share']:.4f}"
            f" (8·N·tokens over {PEAK_FLOPS['bfloat16']:.3g} FLOP/s bf16 "
            f"dense; attention's score products not counted), peak memory "
            f"{peak:.2f} GB; card {card}")
        del trainer, params, opt_state
        torch.cuda.empty_cache()

        # (b) the train step, card against CPU, float32, TF32 off
        t0 = time.time()
        small = get_config(LM_ARCH).smoke().replace(dtype="float32",
                                                    microbatches=2)
        hp = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
        it = GraphWalkCorpus(g, vocab=small.vocab, seed=1).batches(8, 64)
        batches = [next(it) for _ in range(2)]
        start = Model(small, "cpu").init_params(tr.PRNGKey(0))
        runs = []
        for dev in ("cpu", "cuda"):
            # copies: the step updates the weights in place
            p = DenseLM(tree_map(lambda t: t.to(dev, copy=True),
                                 start.tree()), small)
            o = opt.init_opt_state(p)
            step = make_train_step(Model(small, dev), hp)
            losses = []
            for b in batches:
                p, o, m = step(p, o, b)
                losses.append(float(m["loss"]))
            runs.append((losses, [x.cpu() for x in leaves(o.master)]))
        (l_cpu, m_cpu), (l_card, m_card) = runs
        dl = max(abs(a - b) for a, b in zip(l_cpu, l_card))
        dm = max(float((a - b).abs().max()) for a, b in zip(m_cpu, m_card))
        walls["b"] = time.time() - t0
        out["b"] = {"losses_cpu": l_cpu, "losses_card": l_card,
                    "max_loss_diff": dl, "max_master_diff": dm}
        log(f"training (b): L={small.n_layers} d={small.d_model} float32, "
            f"2 microbatches, 2 steps, card vs CPU: losses "
            f"{l_card} vs {l_cpu} (max diff {dl:.3g}, "
            f"tol {CARD_CPU_LOSS_TOL}); max |master diff| {dm:.3g} (tol "
            f"{CARD_CPU_MASTER_TOL})")
        check(dl < CARD_CPU_LOSS_TOL and dm < CARD_CPU_MASTER_TOL,
              "18(b): the card's train step leaves the CPU's")

        # (c) checkpoints at the example's width: resume and a fault
        t0 = time.time()
        ex_cfg = example.config(example.parse_args([]))
        ex_model = Model(ex_cfg, "cuda")
        ex_hp = opt.OptConfig(lr=3e-4, warmup_steps=5, total_steps=20)

        def run(total, ckdir, skip=0, fault=None):
            it = GraphWalkCorpus(g, vocab=ex_cfg.vocab).batches(8, 128)
            for _ in range(skip):
                next(it)
            t = Trainer(ex_model, ex_hp, TrainerConfig(
                total_steps=total, ckpt_every=5, ckpt_dir=ckdir,
                log_every=1000))
            p, o = t.fit(tr.PRNGKey(0), it, fault_hook=fault)
            return t, p, o

        ck = os.path.join(work, "resume")
        run(10, ck)
        t2, p2, o2 = run(20, ck, skip=10)
        check(t2.history[0]["step"] == 11 and int(o2.step) == 20,
              f"18(c): resumed at {t2.history[0]['step']}, ended at "
              f"{int(o2.step)}")
        t3, p3, o3 = run(20, None)
        dm = max(float((a - b).abs().max())
                 for a, b in zip(leaves(o2.master), leaves(o3.master)))
        same = all(torch.equal(a, b) for a, b in
                   zip(leaves(o2.master) + leaves(o2.mu) + leaves(o2.nu),
                       leaves(o3.master) + leaves(o3.mu) + leaves(o3.nu)))
        dloss = max(abs(a["loss"] - b["loss"])
                    for a, b in zip(t2.history, t3.history[10:]))
        # two runs that differ only in the order of float sums differ by
        # at most about 2·lr a step
        tol = 2 * ex_hp.lr * 10
        check(dm <= tol, f"18(c): resumed masters {dm:.3g} from the "
              f"uninterrupted run's (tol {tol:.3g})")
        fired = []

        def fault(step):
            if step == 12 and not fired:
                fired.append(step)
                raise RuntimeError("injected node failure")

        t4, p4, o4 = run(20, os.path.join(work, "fault"), fault=fault)
        check(fired == [12] and int(o4.step) == 20
              and [h["step"] for h in t4.history][10:14] == [11, 12, 11, 12]
              and t4.ckpt._thread is None,
              f"18(c): the fault run: {[h['step'] for h in t4.history]}")
        sizes = sum(os.path.getsize(os.path.join(ck, "step_00000020", f))
                    for f in os.listdir(os.path.join(ck, "step_00000020")))
        walls["c"] = time.time() - t0
        out["c"] = {"resumed_equal": same, "max_master_diff": dm,
                    "max_loss_diff": dloss, "ckpt_MB": sizes / 1e6,
                    "fault_steps": [h["step"] for h in t4.history]}
        log(f"training (c): L={ex_cfg.n_layers} d={ex_cfg.d_model} "
            f"V={ex_cfg.vocab}: 10 steps + resume to 20 (history from "
            f"{t2.history[0]['step']}) against 20 uninterrupted: bit-equal "
            f"state {same}, max |master diff| {dm:.3g} (tol {tol:.3g}), max "
            f"|loss diff| {dloss:.3g}; fault at 12 recovered to 20; a "
            f"checkpoint {sizes / 1e6:.1f} MB")
        del t2, p2, o2, t3, p3, o3, t4, p4, o4, ex_model
        torch.cuda.empty_cache()

        # (d) the fifth example in-process (K2 for its graph)
        t0 = time.time()
        rs.reset_launches()
        res = example.main(["--steps", str(EXAMPLE_STEPS), "--ckpt",
                            os.path.join(work, "example")])
        torch.cuda.synchronize()
        k2_ex = rs.LAUNCHES["rmat_sample_prng"]
        check(k2_ex > 0, "18(d): the example's generate never ran K2")
        err = max(err, k2_unchunked_vs_plain(
            res["graph"], res["pipe"].struct.scaled(1), "18(d) example", tr,
            rmat, sampler, ref, rs, torch))
        losses = res["losses"]
        f10, l10 = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
        check(len(losses) == EXAMPLE_STEPS and l10 < f10,
              f"18(d): first10 {f10:.4f}, last10 {l10:.4f}")
        walls["d"] = time.time() - t0
        out["d"] = {"steps": EXAMPLE_STEPS, "first10": f10, "last10": l10,
                    "k2": k2_ex, "step_ms_median": float(np.median(
                        [h["dt"] for h in res["trainer"].history[1:]])) * 1e3}
        log(f"training (d): the fifth example, {EXAMPLE_STEPS} steps: "
            f"first10 {f10:.4f} last10 {l10:.4f}; K2 {k2_ex} launches")
        del res
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out.update(walls={k: round(v, 2) for k, v in walls.items()},
               wall=round(sum(walls.values()), 2), card=card)
    return out, k2 + k2_ex, err, g


#: phase 19: its wall is logged beside this budget
FAMILY_BUDGET_S = 150.0
#: phase 19(a): each family's config, its depth on the card (None: not
#: cut), the reason for a cut, its K4 launches on one scoring forward
#: (every attention layer; the hybrid's shared block applied 7 times;
#: encdec's 12 decoder layers, its encoder being bidirectional; RWKV6 has
#: no attention) and whether it is served through ``ServingEngine``
FAMILIES = (
    ("qwen3-moe-30b-a3b", 8, "at full depth 61 GB of weights (30.5 B "
     "parameters, ~40 s of draw): most of the card and of the phase's "
     "budget", 8, True),
    ("llama4-scout-17b-16e", 2, "~102 B parameters at full depth", 2, True),
    ("pixtral-12b", 8, "the phase's wall; the dense backbone at full depth "
     "is phase 9's path", 8, False),
    ("zamba2-1.2b", None, "", 7, True),
    ("rwkv6-7b", None, "", 0, True),
    ("seamless-m4t-medium", None, "", 12, False),
)
#: phase 19(b): the scoring batch (VLM: 256 patches + 1792 text tokens;
#: encdec: 1024 frames + 1024 tokens)
FAMILY_B, FAMILY_S = 2, 2048
#: phase 19(c): served requests, slots, cache length and new tokens
SERVE_N, SERVE_SLOTS, SERVE_LEN, SERVE_NEW = 8, 4, 512, 16
#: phase 19(d): card against CPU at the smoke width in float32: logits
#: within 1e-4, the hybrid's 5e-4 (its SSD chunks take exp of differences
#: of cumulative sums and normalise small products, which float32 carries
#: less closely: the tests' ``logit_tol``)
FAMILY_CPU_TOL = {"hybrid": 5e-4}


def _family_batch(cfg, B: int, S: int, seed: int, tr, device: str) -> dict:
    """A scoring batch of ``S`` positions from a seed: tokens = labels,
    plus the VLM's patches or the encdec's frames (half the positions)."""
    n = S
    out = {}
    if cfg.family == "vlm":
        n = S - cfg.vlm.n_patches
        out["patches"] = tr.normal(tr.PRNGKey(seed + 1), (
            B, cfg.vlm.n_patches, cfg.vlm.patch_dim), device)
    if cfg.family == "encdec":
        n = S // 2
        out["frames"] = tr.normal(tr.PRNGKey(seed + 1),
                                  (B, S - n, cfg.d_model), device)
    toks = tr.randint(tr.PRNGKey(seed), (B, n), 0, cfg.vocab, device)
    return {"tokens": toks, "labels": toks, **out}


def _family_scoring(cfg, model, params, expect: int, fa, ref, transformer,
                    Model, tr, torch) -> dict:
    """19(b): one flash-path scoring forward of B x S, K4 against its
    plain version on the family's own layer-0 q/k/v, the einsum path's
    loss beside the flash path's."""
    batch = _family_batch(cfg, FAMILY_B, FAMILY_S, 1, tr, "cuda")
    with first_flash_inputs(fa) as first:
        torch.cuda.synchronize()
        fa.reset_launches()
        t0 = time.time()
        with torch.no_grad():
            out = model.forward(params, batch)
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = fa.LAUNCHES["flash_attention"]
        tc = fa.LAUNCHES["flash_attention_wgmma"]
    logits = out.logits
    loss = transformer.loss_from_logits(logits, batch, cfg,
                                        out.aux_loss).item()
    n_text = batch["tokens"].shape[1]
    rows = FAMILY_S if cfg.family == "vlm" else n_text
    check(tuple(logits.shape) == (FAMILY_B, rows, cfg.vocab),
          f"19(b) {cfg.name}: logits {tuple(logits.shape)}")
    check(bool(torch.isfinite(logits).all()) and loss == loss
          and abs(loss) != float("inf"), f"19(b) {cfg.name}: non-finite")
    check(launches == tc == expect, f"19(b) {cfg.name}: {launches} flash "
          f"launches ({tc} on the tensor-core route), not {expect}")
    del logits, out
    t0 = time.time()
    with torch.no_grad():
        model.forward(params, batch)
    torch.cuda.synchronize()
    wall2 = time.time() - t0
    res = {"first_ms": wall * 1e3, "ms": wall2 * 1e3,
           "tokens_per_s": FAMILY_B * FAMILY_S / wall2, "loss": loss,
           "k4_launches": launches, "k4_err": 0.0}
    if first:
        q, k, v, kw = first[0]
        res["k4_err"] = attn_err(
            fa.flash_attention(q, k, v, **kw),
            ref.attention_ref(q, k, v, causal=kw["causal"],
                              group=kw["group"]))
        res["k4_shape"] = (f"Hq={q.shape[0]} Hkv={k.shape[0]} "
                           f"S={q.shape[1]} d={q.shape[2]}")
        check(res["k4_err"] < 2e-2, f"19(b) {cfg.name}: flash_attention "
              f"disagrees on the path ({res['k4_err']:.3g})")
        del first, q, k, v
        fa.reset_launches()
        t0 = time.time()
        with torch.no_grad():
            out_e = Model(cfg.replace(attn_impl="einsum"), "cuda").forward(
                params, batch)
        torch.cuda.synchronize()
        res["einsum_ms"] = (time.time() - t0) * 1e3
        res["einsum_loss"] = transformer.loss_from_logits(
            out_e.logits, batch, cfg, out_e.aux_loss).item()
        del out_e
        check(fa.LAUNCHES["flash_attention"] == 0,
              f"19(b) {cfg.name}: the einsum path ran the kernel")
        check(abs(loss - res["einsum_loss"]) < 2e-2,
              f"19(b) {cfg.name}: flash and einsum losses differ "
              f"({loss:.6f}, {res['einsum_loss']:.6f})")
    log(f"families (b) {cfg.name}: B={FAMILY_B} S={FAMILY_S} flash forward "
        f"{res['first_ms']:.1f} ms (first), {res['ms']:.1f} ms (second), "
        f"{res['tokens_per_s']:.1f} tokens/s; loss {loss:.6f}; K4 launches "
        f"{launches} (tensor-core {tc}); K4 on layer 0's own q/k/v "
        f"{res.get('k4_shape', '-')}: max|kernel - plain| "
        f"{res['k4_err']:.3g}; einsum path "
        f"{res.get('einsum_ms', float('nan')):.1f} ms, loss "
        f"{res.get('einsum_loss', float('nan')):.6f}")
    return res


def _family_serving(cfg, model, params, ServingEngine, Request, tr,
                    torch) -> dict:
    """19(c): the engine (8 requests, 4 slots).  Every first token is held
    against ``Model.prefill`` of its prompt alone, from the cache the
    engine found in the request's slot: zeros in a fresh slot; in a
    reused one the recurrent states its last request left, where the
    reference's prefill starts (ROADMAP C16), and the number of first
    tokens that then differ from a prefill from zeros is logged."""
    import numpy as np

    TimedEngine = timed_engine(ServingEngine)
    rng = np.random.default_rng(3)
    if cfg.family == "moe":
        # a MoE prompt's tokens must split into min(n_groups, T) groups
        # (ROADMAP C15): multiples of 32
        lengths = rng.integers(1, 9, size=SERVE_N) * 32
    else:
        lengths = rng.integers(16, 257, size=SERVE_N)
    prompts = [rng.integers(0, cfg.vocab, size=int(n), dtype=np.int32)
               for n in lengths]
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = TimedEngine(model, params, max_batch=SERVE_SLOTS,
                      max_len=SERVE_LEN)
    t0 = time.time()
    out = eng.run([Request(i, p, max_new=SERVE_NEW)
                   for i, p in enumerate(prompts)])
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(sorted(out) == list(range(SERVE_N)), f"19(c) {cfg.name}: "
          "requests unanswered")
    check(all(len(v) == SERVE_NEW for v in out.values()),
          f"19(c) {cfg.name}: short answers")
    check(len(eng.found) == SERVE_N, f"19(c) {cfg.name}: admissions")
    differ = 0
    with torch.no_grad():
        for i, p in enumerate(prompts):
            toks = {"tokens": torch.from_numpy(p)[None].cuda()}
            logits, _ = model.prefill(params, toks,
                                      dict(eng.found[i], pos=0))
            first = int(torch.argmax(logits[0].float()))
            check(first == out[i][0], f"19(c) {cfg.name}: request {i}: "
                  f"first token {out[i][0]}, prefill alone {first}")
            if i >= SERVE_SLOTS:
                logits, _ = model.prefill(params, toks,
                                          model.init_cache(1, SERVE_LEN))
                differ += int(torch.argmax(logits[0].float())) != first
    decode_tokens = sum(len(v) - 1 for v in out.values())
    res = {"wall_s": wall, "decode_steps": eng.decode_steps,
           "decode_tokens_per_s": decode_tokens / eng.decode_s,
           "peak_gb": peak, "prompts": [int(n) for n in lengths],
           "reused_slot_first_tokens_unlike_fresh": differ}
    log(f"families (c) {cfg.name}: ServingEngine, {SERVE_N} requests, "
        f"prompts {res['prompts']}, max_new={SERVE_NEW}, {SERVE_SLOTS} "
        f"slots, max_len={SERVE_LEN}: wall {wall:.3f}s; "
        f"{eng.decode_steps} decode steps in {eng.decode_s:.3f}s, "
        f"{res['decode_tokens_per_s']:.1f} decode tokens/s; peak device "
        f"memory {peak:.2f} GB; every first token equals Model.prefill of "
        f"its prompt alone from the slot's cache; {differ} of the "
        f"{SERVE_N - SERVE_SLOTS} in reused slots differ from a prefill "
        "from zeros (C16)")
    return res


def _family_decode(cfg, model, params, encdec, tr, torch) -> dict:
    """19(c) for the VLM and the encdec: ``Model.prefill`` of 2 prompts
    of 128 tokens with their 256 patches or 256 frames, then
    ``SERVE_NEW`` greedy ``decode_step``s."""
    B, n, extra = 2, 128, 256
    toks = tr.randint(tr.PRNGKey(5), (B, n), 0, cfg.vocab, "cuda")
    if cfg.family == "encdec":
        batch = {"tokens": toks, "frames": tr.normal(
            tr.PRNGKey(6), (B, extra, cfg.d_model), "cuda")}
        cache = encdec.init_encdec_cache(cfg, B, n + SERVE_NEW, extra,
                                         "cuda")
        start = n
    else:
        batch = {"tokens": toks, "patches": tr.normal(
            tr.PRNGKey(6), (B, extra, cfg.vlm.patch_dim), "cuda")}
        cache = model.init_cache(B, extra + n + SERVE_NEW)
        start = extra + n
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        t0 = time.time()
        logits, cache = model.prefill(params, batch, cache)
        tok = torch.argmax(logits.float(), dim=-1).to(torch.int32)
        torch.cuda.synchronize()
        prefill_s = time.time() - t0
        toks = [tok]
        t0 = time.time()
        for _ in range(SERVE_NEW):
            tok, cache = model.decode_step(params, {"tokens": tok[:, None]},
                                           cache)
            toks.append(tok)
        torch.cuda.synchronize()
        decode_s = time.time() - t0
    gen = torch.stack(toks, 1)
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(bool(torch.isfinite(logits).all()), f"19(c) {cfg.name}: "
          "non-finite prefill logits")
    check(bool(((gen >= 0) & (gen < cfg.vocab)).all()),
          f"19(c) {cfg.name}: token ids out of range")
    check(cache["pos"] == start + SERVE_NEW,
          f"19(c) {cfg.name}: cache at {cache['pos']}")
    res = {"prefill_ms": prefill_s * 1e3,
           "decode_tokens_per_s": B * SERVE_NEW / decode_s,
           "peak_gb": peak}
    kind = "patches" if cfg.family == "vlm" else "frames"
    log(f"families (c) {cfg.name}: Model.prefill of B={B} x {n} tokens "
        f"with {extra} {kind} {res['prefill_ms']:.1f} ms, then "
        f"{SERVE_NEW} decode_steps: {res['decode_tokens_per_s']:.1f} "
        f"decode tokens/s; peak device memory {peak:.2f} GB")
    return res


def _family_card_vs_cpu(name: str, convert, get_config, Model, moe, tr,
                        torch) -> dict:
    """19(d): the smoke width in float32, card against CPU on the same
    weights and batch: logits; the MoE's top-k ids (equal) and gates
    (1e-6) from each device's routing, and the dispatch buffers of one
    routing (equal); for the hybrid and the SSM prefill + decode against
    the full forward."""
    from types import SimpleNamespace
    cfg = get_config(name).smoke().replace(dtype="float32")
    tol = FAMILY_CPU_TOL.get(cfg.family, 1e-4)
    m_cpu, m_gpu = Model(cfg, "cpu"), Model(cfg, "cuda")
    p_cpu = m_cpu.init_params(tr.PRNGKey(0))
    p_gpu = convert.lm_params_from_numpy(convert.lm_params_to_numpy(p_cpu),
                                         cfg, "cuda")
    b = _family_batch(cfg, 2, 32, 7, tr, "cpu")
    with torch.no_grad():
        want = m_cpu.forward(p_cpu, b).logits
        got = m_gpu.forward(p_gpu, {k: v.cuda() for k, v in b.items()}
                            ).logits
    res = {"logits_err": attn_err(got.cpu(), want)}
    check(res["logits_err"] < tol, f"19(d) {name}: card logits "
          f"{res['logits_err']:.3g} from the CPU's")
    if cfg.family == "moe":
        w = p_cpu.layers[0].moe
        x = tr.normal(tr.PRNGKey(8), (2, 16, cfg.d_model), "cpu")
        E, k = cfg.moe.n_experts, cfg.moe.top_k
        C = max(1, int(16 * k * cfg.moe.capacity_factor / E))
        (e_c, g_c, _), (e_g, g_g, _) = (
            moe._route(x.to(dev), w.gate.to(dev), cfg)
            for dev in ("cpu", "cuda"))
        check(torch.equal(e_c, e_g.cpu()), f"19(d) {name}: top-k ids")
        res["gate_err"] = attn_err(g_g.cpu(), g_c)
        check(res["gate_err"] < 1e-6, f"19(d) {name}: gates")
        # the dispatch of one routing on both devices: equal, exactly
        bufs = [[t.cpu() for t in moe._dispatch_buffers(
            e_c.to(dev), g_c.to(dev), 16, E, C)] for dev in ("cpu", "cuda")]
        check(all(torch.equal(a, b) for a, b in zip(*bufs)),
              f"19(d) {name}: dispatch buffers")
        ffn = [moe.moe_ffn(SimpleNamespace(**{a: getattr(w, a).to(dev) for
                                              a in ("gate", "w1", "w2",
                                                    "w3")}),
                           x.to(dev), cfg)[0].cpu() for dev in ("cpu",
                                                                "cuda")]
        res["moe_ffn_err"] = attn_err(ffn[1], ffn[0])
        check(res["moe_ffn_err"] < 1e-4, f"19(d) {name}: moe_ffn")
    if cfg.family in ("hybrid", "ssm"):
        toks = b["tokens"].cuda()
        S = toks.shape[1] - 1
        with torch.no_grad():
            full = m_gpu.forward(p_gpu, {"tokens": toks}).logits
            cache = m_gpu.init_cache(2, S + 1)
            _, cache = m_gpu.prefill(p_gpu, {"tokens": toks[:, :S]}, cache)
            dec = m_gpu.forward(p_gpu, {"tokens": toks[:, S:]},
                                cache=cache).logits
        res["decode_err"] = attn_err(dec[:, 0], full[:, -1])
        check(res["decode_err"] < tol, f"19(d) {name}: prefill + decode "
              f"{res['decode_err']:.3g} from the full forward")
    log(f"families (d) {name} at smoke width, float32: card vs CPU " +
        ", ".join(f"{k} {v:.3g}" for k, v in res.items()))
    return res


def phase_families(convert, tr, fa, ref, get_config, Model, ServingEngine,
                   Request, torch) -> dict:
    """The other LM families on the card: (a) each at its published width
    from ``init_params(PRNGKey(0))`` (depth cut where logged), (b) one
    scoring forward through the flash path against the einsum path, K4
    against its plain version on the family's own q/k/v, (c) serving,
    (d) card = CPU at the smoke width.  Returns the phase's numbers with
    K4's launches and max error on the path."""
    from repro_torch.models import encdec, moe, transformer

    t_phase = time.time()
    card = gpu_line()
    out = {"card": card}
    launches, err = 0, 0.0
    for name, depth, why, expect, served in FAMILIES:
        cfg = get_config(name).replace(attn_impl="flash")
        full_layers = cfg.n_layers
        if depth is not None:
            cfg = cfg.replace(n_layers=depth)
        model = Model(cfg, "cuda")
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        params = model.init_params(tr.PRNGKey(0))
        torch.cuda.synchronize()
        draw_s = time.time() - t0
        n_params = sum(p.numel() for p in params.parameters())
        n_bytes = sum(p.numel() * p.element_size()
                      for p in params.parameters())
        row = {"layers": cfg.n_layers, "of": full_layers, "cut": why,
               "params": n_params, "gb": n_bytes / 1e9, "draw_s": draw_s,
               "draw_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
        log(f"families (a) {name} [{cfg.family}]: L={cfg.n_layers} of "
            f"{full_layers} d={cfg.d_model} H={cfg.n_heads} "
            f"KV={cfg.n_kv_heads} Hd={cfg.resolved_head_dim} ff={cfg.d_ff} "
            f"V={cfg.vocab} {cfg.dtype}: {n_params} parameters "
            f"({n_bytes / 1e9:.2f} GB) drawn in {draw_s:.2f}s, peak "
            f"{row['draw_peak_gb']:.2f} GB; "
            + (f"depth cut: {why}" if why else "depth and widths not cut"))
        row["b"] = _family_scoring(cfg, model, params, expect, fa, ref,
                                   transformer, Model, tr, torch)
        launches += row["b"]["k4_launches"]
        err = max(err, row["b"]["k4_err"])
        fa.reset_launches()
        if served:
            row["c"] = _family_serving(cfg, model, params, ServingEngine,
                                       Request, tr, torch)
        else:
            row["c"] = _family_decode(cfg, model, params, encdec, tr, torch)
        check(fa.LAUNCHES["flash_attention"] == 0,
              f"19(c) {name}: a cache path ran the flash kernel")
        del params, model
        torch.cuda.empty_cache()
        row["d"] = _family_card_vs_cpu(name, convert, get_config, Model,
                                       moe, tr, torch)
        out[name] = row
    out.update(wall=time.time() - t_phase, k4_launches=launches,
               k4_err=err)
    return out


#: phase 20: its wall is logged beside this budget
FAMILY_TRAIN_BUDGET_S = 120.0
#: phase 20(a): each family's config, its depth on the card (None: not
#: cut), the reason for a cut and its config's microbatches.  A step holds
#: ~20 bytes a parameter (bf16 weights and gradients, the float32 gradient
#: sum, float32 masters and two moments)
TRAIN_FAMILIES = (
    ("qwen3-moe-30b-a3b", 2, "~37 GB of training state at 2 of 48 layers "
     "(0.62 B embed + head, 0.62 B a layer); ~20 bytes a parameter",
     8),
    ("pixtral-12b", 4, "~49 GB of training state at 4 of 40 layers (1.35 B "
     "embed + head, 0.27 B a layer)", 8),
    ("zamba2-1.2b", None, "", 4),
    ("rwkv6-7b", 8, "~46 GB of training state at 8 of 32 layers (0.54 B "
     "embed + head, 0.22 B a layer)", 8),
    ("seamless-m4t-medium", None, "", 2),
)
#: phase 20(a): the family left out on the card, and why
TRAIN_NOT_ON_CARD = (
    ("llama4-scout-17b-16e", "not on one card: ~83 GB of training state at "
     "one layer; sharding it needs more than one card (phase 21's "
     "dry-run plans its fsdp cell)"),)
#: phase 20(a): the batch (B x S positions: the VLM 256 patches + 1792
#: text tokens, the encdec 1024 frames + 1024 tokens) and the steps
FAMILY_TRAIN_B, FAMILY_TRAIN_S, FAMILY_TRAIN_STEPS = 8, 2048, 3
#: phase 20(a): zamba2's published SSD chunk, where the reference's
#: gradient is non-finite (ROADMAP C17)
HYBRID_CHUNK = 128
#: phase 20(b): card against CPU at the smoke width, float32, as 18(b):
#: losses within ``CARD_CPU_LOSS_TOL``; the first batch's gradients within
#: ``FAMILY_GRAD_REL`` of each leaf's largest; the masters after 2 steps
#: within ``CARD_CPU_MASTER_TOL`` where the first gradient's |g| >=
#: ``_adam_sure`` of it, within 2·(lr_1 + lr_2) elsewhere.  Adam's first
#: update lr·c·g/(|c·g| + 1e-8) (c the clip factor) moves by up to lr
#: where g is near 1e-8 and its last bits differ (pixtral's masters part
#: by 1.58e-4 there), by under lr·1e-8·tol/(c·g²) elsewhere.
#: ``FAMILY_GRAD_REL`` is 2e-3 because the float32 gradients of RWKV6
#: and the hybrid are ill-conditioned on some batches: on this phase's
#: first batch rwkv6's card and CPU gradients part by ~2.7e-4 of the
#: embedding's largest, and the JAX package's CPU gradients part from the
#: port's by as much; the hybrid's reach 7.1e-4 between the reference's
#: own jitted and op-by-op evaluations
#: (``tests/_torch_families_common.HYBRID_GRAD_REL``).  The hybrid's
#: losses within 1e-3 and masters within 2e-3 everywhere: its training is
#: sensitive to the last bits of its start (a factor 1 + 1e-7 on the
#: initial weights moves the reference's second loss by 3.9e-4,
#: ``tests/test_torch_families_trainer_recurrent.py``).
FAMILY_GRAD_REL = 2e-3
FAMILY_TRAIN_CPU_TOL = {"hybrid": (1e-3, 2e-3)}


def _adam_sure(lr: float, clip: float, tol: float) -> float:
    """The least |g| at which a gradient error within ``tol`` moves
    Adam's first update by under ``CARD_CPU_MASTER_TOL``."""
    return max(1e-5, (lr * 1e-8 * tol / (CARD_CPU_MASTER_TOL * clip)) ** 0.5)


def _active_params(cfg, abstract) -> int:
    """Parameters a token meets: every one, but of the MoE's experts only
    the top-k of E (attention, router, norms, embedding and head all)."""
    from repro_torch.utils import tree_size
    n = tree_size(abstract)
    if cfg.family == "moe":
        moe = abstract["layers"]["moe"]
        experts = sum(tree_size(moe[k]) for k in ("w1", "w2", "w3"))
        n -= experts * (cfg.moe.n_experts - cfg.moe.top_k) // \
            cfg.moe.n_experts
    return n


def _train_batches(cfg, corpus, B: int, S: int, seed: int, device: str):
    """Endless training batches of ``S`` positions: walk tokens from
    ``corpus`` (``S`` of them; the VLM ``S − n_patches`` after its
    patches, the encdec ``S / 2`` after its frames) and seeded normal
    patches or frames, float32 (the step casts them to the params'
    dtype)."""
    from repro_torch import random as tr
    n = S
    if cfg.family == "vlm":
        n = S - cfg.vlm.n_patches
    if cfg.family == "encdec":
        n = S // 2
    it = corpus.batches(B, n)
    i = 0
    while True:
        b = dict(next(it))
        key = tr.PRNGKey(seed + i)
        if cfg.family == "vlm":
            b["patches"] = tr.normal(key, (B, cfg.vlm.n_patches,
                                           cfg.vlm.patch_dim), device)
        if cfg.family == "encdec":
            b["frames"] = tr.normal(key, (B, S - n, cfg.d_model), device)
        i += 1
        yield b


def _family_train(name: str, depth, why: str, micro: int, g, fa, tr,
                  get_config, Model, torch) -> dict:
    """20(a): one family at its published widths trained by ``Trainer``
    for ``FAMILY_TRAIN_STEPS`` steps."""
    import numpy as np
    from repro_torch.data.pipeline import GraphWalkCorpus
    from repro_torch.kernels.bounds import PEAK_FLOPS
    from repro_torch.training import optimizer as opt
    from repro_torch.training.trainer import Trainer, TrainerConfig
    from repro_torch.utils import tree_size

    cfg = get_config(name).replace(attn_impl="einsum", remat=True,
                                   remat_policy="nothing")
    full_layers = cfg.n_layers
    if depth is not None:
        cfg = cfg.replace(n_layers=depth)
    check(cfg.microbatches == micro, f"20(a) {name}: microbatches "
          f"{cfg.microbatches}, not its config's {micro}")
    if cfg.family == "hybrid":
        check(cfg.ssm.chunk == HYBRID_CHUNK, f"20(a) {name}: SSD chunk "
              f"{cfg.ssm.chunk}, not the published {HYBRID_CHUNK}")
    model = Model(cfg, "cuda")
    abstract = model.abstract_params()
    n_params = tree_size(abstract)
    n_active = _active_params(cfg, abstract)
    # the lr ramps over the steps (1e-4, 2e-4, 3e-4), as 18(a)'s warmup
    trainer = Trainer(model, opt.OptConfig(warmup_steps=FAMILY_TRAIN_STEPS,
                                           total_steps=FAMILY_TRAIN_STEPS),
                      TrainerConfig(total_steps=FAMILY_TRAIN_STEPS,
                                    log_every=1000))
    inner_init, draw = trainer.init_state, {}

    def init_state(rng):
        t0 = time.time()
        state = inner_init(rng)
        torch.cuda.synchronize()
        draw["s"] = time.time() - t0
        return state

    trainer.init_state = init_state
    first = watch_first_step(trainer)
    corpus = GraphWalkCorpus(g, vocab=cfg.vocab)
    data = _train_batches(cfg, corpus, FAMILY_TRAIN_B, FAMILY_TRAIN_S, 11,
                          "cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fa.reset_launches()
    t0 = time.time()
    params, opt_state = trainer.fit(tr.PRNGKey(0), data)
    torch.cuda.synchronize()
    wall = time.time() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    hist = trainer.history
    check(len(hist) == FAMILY_TRAIN_STEPS and int(opt_state.step) ==
          FAMILY_TRAIN_STEPS, f"20(a) {name}: {len(hist)} steps")
    check(all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
              and h["grad_norm"] > 0 for h in hist),
          f"20(a) {name}: a loss or grad norm not finite and positive: "
          f"{hist}")
    check(all(first["moved"]) and all(first["mu"]),
          f"20(a) {name}: after step 1, masters moved {first['moved']}, "
          f"first moments nonzero {first['mu']}")
    check(fa.LAUNCHES["flash_attention"] == 0,
          f"20(a) {name}: the einsum path ran the flash kernel")
    step_s = float(np.median([h["dt"] for h in hist[1:]]))
    tokens = FAMILY_TRAIN_B * FAMILY_TRAIN_S
    flops = 8 * n_active * tokens     # 6N a token, +2N for remat's forward
    row = {"layers": cfg.n_layers, "of": full_layers, "cut": why,
           "params": n_params, "active_params": n_active,
           "microbatches": cfg.microbatches, "draw_s": draw["s"],
           "loss": [h["loss"] for h in hist],
           "grad_norm": [h["grad_norm"] for h in hist],
           "step_s": [h["dt"] for h in hist], "warm_step_s": step_s,
           "tokens_per_s": tokens / step_s,
           "model_flops_share": flops / step_s / PEAK_FLOPS["bfloat16"],
           "peak_gb": peak, "wall_s": wall}
    if cfg.family == "hybrid":
        row["ssd_chunk"] = cfg.ssm.chunk
    log(f"family training (a) {name} [{cfg.family}]: L={cfg.n_layers} of "
        f"{full_layers} d={cfg.d_model} V={cfg.vocab} {cfg.dtype}, "
        f"{n_params} parameters ({n_active} active a token), drawn in "
        f"{draw['s']:.2f}s; B={FAMILY_TRAIN_B} x S={FAMILY_TRAIN_S} in "
        f"{cfg.microbatches} microbatches, remat 'nothing', einsum "
        f"attention" + (f", SSD chunk {cfg.ssm.chunk}"
                        if cfg.family == "hybrid" else "") +
        f"; {FAMILY_TRAIN_STEPS} Trainer steps: losses "
        f"{[round(h['loss'], 4) for h in hist]}, grad norms "
        f"{[round(h['grad_norm'], 4) for h in hist]}, step s "
        f"{[round(h['dt'], 3) for h in hist]} (warm {step_s:.3f}), "
        f"{tokens / step_s:.0f} tokens/s, model-FLOPs share "
        f"{row['model_flops_share']:.4f} (8·N_active·tokens over "
        f"{PEAK_FLOPS['bfloat16']:.3g} FLOP/s bf16 dense), peak memory "
        f"{peak:.2f} GB; " + (f"depth cut: {why}" if why else
                              "depth and widths not cut"))
    del trainer, params, opt_state, data
    torch.cuda.empty_cache()
    return row


def _family_train_card_vs_cpu(name: str, g, tr, get_config, Model,
                              torch) -> dict:
    """20(b): the train step at the smoke width in float32, 2
    microbatches, the same params, state and 2 batches on the CPU and on
    the card; the first batch's gradients beside it."""
    from repro_torch.data.pipeline import GraphWalkCorpus
    from repro_torch.models.params import leaves, tree_map
    from repro_torch.models.transformer import LM
    from repro_torch.training import optimizer as opt
    from repro_torch.training.steps import make_train_step

    small = get_config(name).smoke().replace(dtype="float32",
                                             microbatches=2)
    hybrid = small.family == "hybrid"
    tol_loss, tol_master = FAMILY_TRAIN_CPU_TOL.get(
        small.family, (CARD_CPU_LOSS_TOL, None))
    hp = opt.OptConfig(lr=1e-3, warmup_steps=2, total_steps=20)
    it = _train_batches(small, GraphWalkCorpus(g, vocab=small.vocab,
                                               seed=1), 8, 64, 21, "cpu")
    batches = [next(it) for _ in range(2)]
    start = Model(small, "cpu").init_params(tr.PRNGKey(0))
    runs = []
    for dev in ("cpu", "cuda"):
        p = LM(tree_map(lambda t: t.to(dev, copy=True), start.tree()),
               small)
        model = Model(small, dev)
        ws = leaves(p.tree())
        for w in ws:
            w.requires_grad_(True)
        b0 = {k: torch.as_tensor(v).to(dev) for k, v in batches[0].items()}
        grads = [x.cpu() for x in torch.autograd.grad(model.loss(p, b0),
                                                      ws)]
        o = opt.init_opt_state(p)
        step = make_train_step(model, hp)
        losses = []
        for b in batches:
            p, o, m = step(p, o, b)
            losses.append(float(m["loss"]))
        runs.append((losses, grads, [x.cpu() for x in leaves(o.master)]))
    (l_cpu, g_cpu, m_cpu), (l_card, g_card, m_card) = runs
    dl = max(abs(a - b) for a, b in zip(l_cpu, l_card))
    g_tols = [FAMILY_GRAD_REL * float(a.abs().max()) for a in g_cpu]
    dg = max(float((a - b).abs().max()) / t
             for a, b, t in zip(g_cpu, g_card, g_tols))
    gnorm = float(sum((a.double() ** 2).sum() for a in g_cpu) ** 0.5)
    lrs = [float(opt.lr_schedule(hp, s)) for s in (1, 2)]
    clip = min(1.0, hp.max_grad_norm / gnorm)
    sure = [_adam_sure(lrs[0], clip, t) for t in g_tols]
    dm_sure = dm_all = 0.0
    for a, b, gc, thr in zip(m_cpu, m_card, g_cpu, sure):
        d = (a - b).abs()
        dm_all = max(dm_all, float(d.max()))
        big = gc.abs() >= thr
        if bool(big.any()):
            dm_sure = max(dm_sure, float(d[big].max()))
    if hybrid:
        ok_m = dm_all < tol_master
        m_text = f"max |master diff| {dm_all:.3g} (tol {tol_master})"
    else:
        ok_m = dm_sure < CARD_CPU_MASTER_TOL and dm_all <= 2 * sum(lrs)
        m_text = (f"max |master diff| {dm_sure:.3g} where the first "
                  f"gradient is sure (tol {CARD_CPU_MASTER_TOL}), "
                  f"{dm_all:.3g} anywhere (tol 2·(lr_1 + lr_2) = "
                  f"{2 * sum(lrs):.3g})")
    log(f"family training (b) {name} at smoke width, float32, 2 "
        f"microbatches, 2 steps, card vs CPU: losses {l_card} vs {l_cpu} "
        f"(max diff {dl:.3g}, tol {tol_loss}); first batch's gradients: "
        f"max |diff| {dg:.3g} of the limit ({FAMILY_GRAD_REL} of each "
        f"leaf's largest); {m_text}")
    check(dl < tol_loss and dg < 1.0 and ok_m,
          f"20(b) {name}: the card's train step leaves the CPU's")
    return {"losses_cpu": l_cpu, "losses_card": l_card,
            "max_loss_diff": dl, "grad_diff_of_limit": dg,
            "max_master_diff_sure": dm_sure, "max_master_diff": dm_all}


def phase_family_training(g, fa, tr, get_config, Model, torch) -> dict:
    """The other LM families trained on the card: (a) each at its
    published widths (depth cut where logged; llama4-scout left out) by
    ``Trainer`` on walk tokens over phase 18's ×1 graph, (b) the train
    step card = CPU at each ``smoke()`` width.  Returns the phase's
    numbers."""
    t_phase = time.time()
    card = gpu_line()
    out = {"card": card, "a": {}, "b": {}}
    for name, why in TRAIN_NOT_ON_CARD:
        out["a"][name] = {"cut": why}
        log(f"family training (a) {name}: left out: {why}")
    for name, depth, why, micro in TRAIN_FAMILIES:
        out["a"][name] = _family_train(name, depth, why, micro, g, fa, tr,
                                       get_config, Model, torch)
    walls = {"a": time.time() - t_phase}
    t0 = time.time()
    for name in [n for n, *_ in TRAIN_FAMILIES] + \
            [n for n, _ in TRAIN_NOT_ON_CARD]:
        out["b"][name] = _family_train_card_vs_cpu(name, g, tr, get_config,
                                                   Model, torch)
    walls["b"] = time.time() - t0
    out.update(walls=walls, wall=time.time() - t_phase)
    return out


#: phase 21: its wall is logged beside this budget
PLAN_BUDGET_S = 120.0
#: phase 21(a): the cells the dry-run writes (every arch at train_4k on the
#: single production mesh, the graph-generation cell), their probe runs
#: over this many processes (the card's machine has 8 cores)
PLAN_SHAPE, PLAN_JOBS = "train_4k", 8
#: phase 21(b): predicted against measured peak memory, at most this apart
PLAN_CALIB_TOL = 0.15
#: phase 21(c): the 1 × 1-mesh step against the plain step, relative
PLAN_STEP_TOL = 1e-6
#: phase 21(e): edges a device of the generation cell
PLAN_GEN_EDGES = 1 << 24
#: phase 21(b): the probe of phase 18's step on a 1 × 1 placeholder mesh,
#: its memory and FLOPs as JSON (argv: arch, batch, sequence)
PLAN_CALIB_SCRIPT = """
import json, sys
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import costs, dryrun, mesh
from repro_torch.training.steps import build_cell
mesh.fake_process_group(1)
m = mesh.make_local_mesh(1, 1)
cfg = get_config(sys.argv[1])
shape = ShapeSpec("phase18", int(sys.argv[3]), int(sys.argv[2]), "train")
p = costs.probe_costs(cfg, shape, m)
cell = build_cell(cfg, shape, m, device="meta")
print(json.dumps({"memory": dryrun.memory_analysis(cell, cfg, shape,
                                                   p.temp_bytes),
                  "flops": p.flops, "model_flops":
                  costs.model_flops(cfg, shape)}))
"""


class PlanHost:
    """Phase 21(a)'s and (b)'s host processes (no card: the dry-run is
    host work on ``meta`` tensors), started before phase 18 at the lowest
    CPU priority, so that they take the cores the card's phases leave
    idle; ``close`` stops any still running and removes their work."""

    def __init__(self):
        import os
        import tempfile
        self.work = tempfile.mkdtemp(prefix="chip_smoke_plan_")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                   CUDA_VISIBLE_DEVICES="")
        cmds = {"cells": ["-m", "repro_torch.launch.dryrun", "--all",
                          "--shape", PLAN_SHAPE, "--jobs", str(PLAN_JOBS),
                          "--out", self.work],
                "graphgen": ["-m", "repro_torch.launch.dryrun",
                             "--graphgen", "--out", self.work],
                "calibration": ["-c", PLAN_CALIB_SCRIPT, LM_ARCH,
                                str(TRAIN_B), str(TRAIN_S)]}
        self.t0 = time.time()
        self.procs = {}
        for name, args in cmds.items():
            path = os.path.join(self.work, f"{name}.log")
            with open(path, "w") as f:
                p = subprocess.Popen([sys.executable] + args, stdout=f,
                                     stderr=subprocess.STDOUT, cwd=str(ROOT),
                                     env=env)
            os.setpriority(os.PRIO_PROCESS, p.pid, 19)
            self.procs[name] = (p, path)

    def wait(self) -> float:
        """Wait for every process (each must exit 0); the seconds from
        their start to the last one's end."""
        for name, (p, path) in self.procs.items():
            rc = p.wait(timeout=PLAN_BUDGET_S * 4)
            if rc != 0:
                log(open(path).read()[-3000:])
            check(rc == 0, f"21: the {name} process exited {rc}")
        return time.time() - self.t0

    def close(self) -> None:
        import shutil
        for p, _ in self.procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(self.work, ignore_errors=True)


def _plan_step(g, get_config, Model, tr, torch) -> dict:
    """21(c): two steps of full-width tinyllama-1.1b on DTensor weights on
    a 1 × 1 mesh of ``cuda:0`` against the plain step from the same
    weights and batches."""
    import torch.distributed as dist
    from repro_torch.data.pipeline import GraphWalkCorpus
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training import steps
    cfg = get_config(LM_ARCH).replace(attn_impl="einsum", remat=True,
                                      remat_policy="nothing")
    hp = opt.OptConfig(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS)
    it = GraphWalkCorpus(g, vocab=cfg.vocab).batches(TRAIN_B, TRAIN_S)
    batches = [next(it) for _ in range(2)]
    model = Model(cfg, "cuda")
    runs = []
    for mesh in (None, "1x1"):
        params = model.init_params(tr.PRNGKey(0))
        state = opt.init_opt_state(params)
        if mesh is not None:
            mesh = make_local_mesh(1, 1, device_type="cuda")
            rules = shd.make_rules(cfg, mesh)
            state = steps.place(state, steps.opt_state_shardings(
                opt.abstract_opt_state(model.abstract_params()),
                model.param_dims(), rules, mesh))
            params = steps.place(params, shd.tree_shardings(
                model.param_dims(), model.abstract_params(), rules, mesh))
            placed = type(leaves(params.tree())[0]).__name__
        step = steps.make_train_step(model, hp, mesh)
        losses, lrs = [], []
        t0 = time.time()
        for b in batches:
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            if mesh is None and len(losses) == 1:
                # the first moment after step 1 is (1 − β1)·clipped g₁
                g1 = [t.cpu() / (1 - hp.beta1) for t in leaves(state.mu)]
        torch.cuda.synchronize()
        dt = time.time() - t0
        masters = [(t.full_tensor() if mesh is not None else t).cpu()
                   for t in leaves(state.master)]
        runs.append((losses, masters, dt))
        del params, state, step
        torch.cuda.empty_cache()
    dist.destroy_process_group()
    (l0, m0, t_plain), (l1, m1, t_mesh) = runs
    dl = max(abs(a - b) / abs(a) for a, b in zip(l0, l1))
    # masters to PLAN_STEP_TOL of each leaf's largest where Adam's first
    # update is sure of its gradient (|g₁| ≥ 1e-5, or 0), to 2·(lr₁ +
    # lr₂) elsewhere: lr·g/(|g| + 1e-8) turns a last-bit gradient
    # difference near 1e-8 into a part of lr (phase 20's _adam_sure)
    dm = dm_all = 0.0
    unsure = 0
    for a, b, g in zip(m0, m1, g1):
        sure = (g.abs() >= 1e-5) | (g == 0)
        d = (a - b).abs()
        scale = max(float(a.abs().max()), 1e-30)
        dm = max(dm, float(d[sure].max()) / scale if sure.any() else 0.0)
        dm_all = max(dm_all, float(d.max()))
        unsure += int((~sure).sum())
    same = l0 == l1 and all(torch.equal(a, b) for a, b in zip(m0, m1))
    log(f"plan (c): {LM_ARCH} full width, 2 steps at B={TRAIN_B} x "
        f"S={TRAIN_S}, the weights {placed}s on a 1 x 1 mesh of cuda:0 "
        f"against the plain step from the same weights and batches: losses "
        f"{l1} vs {l0}, max relative loss diff {dl:.3g}; masters: max "
        f"relative diff {dm:.3g} where Adam is sure (tol {PLAN_STEP_TOL}), "
        f"max |diff| {dm_all:.3g} anywhere (bound {2 * sum(lrs):.3g}, "
        f"{unsure} entries with 0 < |g1| < 1e-5); bit-equal {same}; 2 "
        f"steps {t_mesh:.2f} s on the mesh, {t_plain:.2f} s plain")
    check(placed == "DTensor", "21(c): the weights are not DTensors")
    check(dl <= PLAN_STEP_TOL and dm <= PLAN_STEP_TOL
          and dm_all <= 2 * sum(lrs),
          "21(c): the 1 x 1-mesh step leaves the plain step")
    return {"losses_plain": l0, "losses_mesh": l1, "max_loss_rel": dl,
            "max_master_rel_sure": dm, "max_master_abs": dm_all,
            "unsure_entries": unsure, "bit_equal": same,
            "two_steps_s_mesh": t_mesh, "two_steps_s_plain": t_plain}


def _plan_compression(torch) -> dict:
    """21(d): ``compress_tree`` on the card against the CPU on the same
    seeded gradients, with a carried error buffer: bit for bit."""
    import numpy as np
    from repro_torch.distributed import compression as comp
    r = np.random.default_rng(21)
    rounds = [{"w": r.normal(0, 1, (4096, 1024)).astype(np.float32),
               "b": r.normal(0, 1e-3, (4096,)).astype(np.float32),
               "e": r.normal(0, 30, (64, 64, 64)).astype(np.float32)}
              for _ in range(2)]
    out = {}
    for dev in ("cpu", "cuda"):
        g0 = {k: torch.from_numpy(v).to(dev) for k, v in rounds[0].items()}
        e = comp.init_error_buffer(g0)
        got = []
        for g in rounds:
            q, s, e = comp.compress_tree({k: torch.from_numpy(v).to(dev)
                                          for k, v in g.items()}, e)
            got.append([t.cpu() for part in (q, s, e)
                        for t in (part[k] for k in sorted(part))])
        out[dev] = got
    same = all(a.dtype == b.dtype and torch.equal(a, b)
               for ra, rb in zip(out["cpu"], out["cuda"])
               for a, b in zip(ra, rb))
    n = sum(v.size for v in rounds[0].values())
    log(f"plan (d): compress_tree, 2 rounds with error feedback on "
        f"{n} float32 gradient entries in 3 leaves: int8 values, scales "
        f"and residuals card = CPU bit for bit: {same}")
    check(same, "21(d): the card's int8 compression differs from the CPU's")
    return {"entries": n, "bit_equal": same}


def _plan_generation(tr, ref, rs, torch) -> tuple:
    """21(e): the generation cell on a one-device mesh of the card (K2
    for ``PLAN_GEN_EDGES`` edges at n = m = 30), its edges/s beside its
    roofline; K2 at that shape against its plain version."""
    import numpy as np
    from repro_torch.core import sampler
    from repro_torch.core.distributed_gen import (build_generation_cell,
                                                  step_seeds)
    cell = build_generation_cell(1, "1t", PLAN_GEN_EDGES, devices=["cuda"])
    L = cell.args[0].shape[0]
    thetas = torch.tensor([DEMO_THETA] * L, dtype=torch.float32,
                          device="cuda")
    seeds = step_seeds(0, 0, 1)
    torch.cuda.synchronize()
    rs.reset_launches()
    src, dst = cell.fn(thetas, seeds)
    torch.cuda.synchronize()
    launches = rs.LAUNCHES["rmat_sample_prng"]
    check(launches > 0, "21(e): the generation cell never ran K2")
    check(src.shape == (1, PLAN_GEN_EDGES) and int(src.min()) >= 0
          and int(dst.min()) >= 0, "21(e): ids out of range")
    ms = min(cuda_ms(lambda: cell.fn(thetas, seeds), 3) for _ in range(2))
    comp, mem = cell.costs["operations_s"], cell.costs["bytes_s"]
    roof = cell.meta["edges"] / max(comp, mem)
    eps = cell.meta["edges"] / (ms / 1e3)
    key = tr.fold_in(tr.PRNGKey(0), int(seeds[0]))
    pad = sampler._pad_edges(PLAN_GEN_EDGES,
                             sampler.choose_block(PLAN_GEN_EDGES))
    err = max_word_err(rs.rmat_sample_prng(key, thetas, L, L,
                                           PLAN_GEN_EDGES, pad),
                       ref.rmat_prng_ref(key, thetas, L, L, PLAN_GEN_EDGES,
                                         pad))
    check(err == 0, f"21(e): K2 at the cell's shape differs from its plain "
          f"version ({err})")
    log(f"plan (e): the generation cell on one device (n=m={L}, "
        f"{PLAN_GEN_EDGES} edges, K2 {launches} launch(es)): {ms:.3f} ms a "
        f"step, {eps:.4g} edges/s beside its roofline "
        f"{roof:.4g} edges/s ({eps / roof:.1%}; operations "
        f"{comp * 1e3:.3f} ms, bytes {mem * 1e3:.3f} ms); K2 vs plain at "
        f"that shape max|err| {err}")
    return ({"edges": cell.meta["edges"], "step_ms": ms,
             "edges_per_s": eps, "edges_per_s_roofline": roof,
             "share": eps / roof}, launches, err)


def phase_plan(host: PlanHost, g, train: dict, tr, ref, rs, get_config,
               Model, torch) -> tuple:
    """Phase 21: the production mesh planned without a card, and the
    mesh-aware pieces on it.  (a) the dry-run of every architecture at
    ``PLAN_SHAPE`` on the single production mesh (its probe runs over
    ``PLAN_JOBS`` processes) and the graph-generation cell, ``host``'s
    processes, started before phase 18; (b) the memory model against
    phase 18's measured peak; (c) the 1 × 1-mesh train step; (d) int8
    compression card = CPU; (e) the generation cell through K2.  Returns
    the phase's numbers, K2's launches and its max error."""
    import json as _json
    import os
    t_phase = time.time()
    card = gpu_line()
    work, procs = host.work, host.procs
    out = {"card": card}
    t0 = time.time()
    out["c"] = _plan_step(g, get_config, Model, tr, torch)
    out["d"] = _plan_compression(torch)
    out["e"], k2, err = _plan_generation(tr, ref, rs, torch)
    t_card = time.time() - t0
    t_host = host.wait()
    # (a)
    cells = {}
    for fname in sorted(os.listdir(work)):
        if fname.endswith(".json"):
            with open(os.path.join(work, fname)) as f:
                cells[fname[:-5]] = _json.load(f)
    lines = []
    for name, c in cells.items():
        check(c["status"] in ("ok", "skipped"),
              f"21(a): {name} is {c['status']}: {c.get('error')}")
        if c["status"] == "skipped":
            lines.append(f"{name}: skipped ({c['reason']})")
            continue
        rl = c["roofline"]
        if c.get("arch") == "graphgen-rmat":
            lines.append(
                f"{name}: {rl['edges']:.4g} edges a step, roofline "
                f"{rl['edges_per_s_roofline']:.4g} edges/s "
                f"({rl['dominant']}), no collective")
            continue
        peak = c["memory_analysis"]["peak_bytes_per_device"]
        lines.append(
            f"{name}: peak {peak / 2**30:.2f} GiB a device of 80 GB "
            f"({peak / 80e9:.0%}); compute {rl['compute_s']:.4g} s, "
            f"memory {rl['memory_s']:.4g} s, collective "
            f"{rl['collective_s']:.4g} s, dominant {rl['dominant']}, "
            f"useful {rl['useful_ratio']:.3f}; probe "
            f"{c['t_probe_s']} s" + (" (fsdp)" if c["config"]["fsdp"]
                                      else ""))
    from repro_torch.benchmarks import roofline
    from repro_torch.configs import ARCHS
    check(len(cells) == len(ARCHS) + 1, f"21(a): {len(cells)} cells")
    log("plan (a): the dry-run on the (16, 16) production mesh "
        "(a placeholder group of 512 ranks, meta tensors, no card), "
        "H100 constants:\n  " + "\n  ".join(lines))
    # the 15th table, from these cells
    tables = (roofline.dryrun_table(list(cells.values())) + "\n\n"
              + roofline.roofline_table(list(cells.values())))
    check(all(f"| {a} | {PLAN_SHAPE} |" in tables for a in ARCHS),
          "21(a): the roofline tables miss a cell")
    log("plan (a): benchmarks/roofline's tables of these cells:\n"
        + tables)
    out["a"] = {n: {k: c.get(k) for k in ("status", "memory_analysis",
                                           "roofline", "t_probe_s")}
                for n, c in cells.items()}
    # (b)
    with open(procs["calibration"][1]) as f:
        calib = _json.loads(f.read().strip().splitlines()[-1])
    ta = train["a"]
    held = ta["params"] * 2      # watch_first_step's bf16 clone
    predicted = calib["memory"]["peak_bytes_per_device"] + held
    measured = ta["peak_mem_GB"] * 1e9
    gap = predicted / measured - 1
    share = calib["flops"] / (ta["step_ms_median_2_on"] / 1e3) / \
        PEAK_FLOPS["bfloat16"]
    log(f"plan (b): {LM_ARCH} at B={TRAIN_B} x S={TRAIN_S} on a 1 x 1 "
        f"mesh: predicted peak {predicted / 1e9:.2f} GB (step "
        f"{calib['memory']['peak_bytes_per_device'] / 1e9:.2f} GB: "
        f"arguments {calib['memory']['argument_bytes'] / 1e9:.2f} + temp "
        f"{calib['memory']['temp_bytes'] / 1e9:.2f}; + phase 18's "
        f"first-step weight copy {held / 1e9:.2f}) against phase 18's "
        f"measured {measured / 1e9:.2f} GB: {gap:+.1%} (tol "
        f"{PLAN_CALIB_TOL:.0%}); counted FLOPs {calib['flops']:.4g} over "
        f"phase 18's step {ta['step_ms_median_2_on']:.1f} ms: "
        f"model-FLOPs share {share:.4f} (phase 18's 8·N·tokens: "
        f"{ta['model_flops_share']:.4f}); card {card}")
    check(abs(gap) <= PLAN_CALIB_TOL, "21(b): the memory model leaves "
          "the measured peak")
    out["b"] = {"predicted_GB": predicted / 1e9,
                "measured_GB": measured / 1e9, "gap": gap,
                "counted_flops": calib["flops"],
                "counted_flops_share": share,
                "phase18_share": ta["model_flops_share"]}
    out.update(wall=time.time() - t_phase, card_s=t_card,
               host_s_from_start=t_host)
    log(f"plan: the host processes ended {t_host:.1f}s after their start "
        "before phase 18 (lowest CPU priority)")
    return out, k2, err


#: phase 22's budget and sizes: the stress runs (KDE + random aligner,
#: the JAX package's stress spec; the committed asset's GAN + GBDT at its
#: ×1, 40 000 edges) in shards of 4096 edges (10 a run), the load audit
#: at the module's defaults (8 shards of 8192)
ANALYSIS_BUDGET_S = 30.0
ANALYSIS_EDGES, ANALYSIS_SHARD = 40_000, 4096
ANALYSIS_AUDIT_EDGES, ANALYSIS_AUDIT_SHARD = 60_000, 8192
#: the stress and audit jobs' structure (``analysis.races.run_stress``,
#: ``analysis.retrace.run_retrace``)
ANALYSIS_N = 12
#: what the stress runs must have watched
ANALYSIS_WATCHED = ("FeatureSpec.feat_s", "AsyncFlushQueue.busy_s",
                    "Tracer._totals")


def _analysis_stress(label: str, run, work: str, torch) -> dict:
    """One lockset stress run at depth 2 × 2 workers and the same job at
    depth 0, both on the card: ``run(path, depth, workers)`` returns the
    monitor and the job's directory."""
    import os
    from repro_torch.datastream import Manifest, ShardedGraphDataset
    t0 = time.time()
    mon = run(os.path.join(work, f"{label}-pipelined"), 2, 2)
    torch.cuda.synchronize()
    t_run = time.time() - t0
    serial = os.path.join(work, f"{label}-serial")
    run(serial, 0, 1)
    piped = os.path.join(work, f"{label}-pipelined")
    races_found = [r.render() for r in mon.races()]
    states = {v: mon.state_of(v) for v in
              (*ANALYSIS_WATCHED, "FeatureSpec.align_s",
               "ShardWriter._since_checkpoint",
               "ChunkShardSource._suffix_dev")}
    problems = ShardedGraphDataset(piped).verify(deep=True)
    n_shards = len(Manifest.load(piped).shards)
    same = _shards_equal(piped, serial) and \
        _sans_executor(piped) == _sans_executor(serial)
    log(f"analysis (b) {label}: {n_shards} shards at depth 2 x 2 workers "
        f"in {t_run:.3f}s: {mon.summary()}; states {states}; deep verify "
        f"{problems}; shards and manifest (bar the executor) equal to "
        f"depth 0 on the card: {same}")
    check(not races_found, f"22(b) {label}: candidate races: {races_found}")
    check(all(states[v] != "unwatched" for v in ANALYSIS_WATCHED),
          f"22(b) {label}: the watched surface was not exercised: {states}")
    check(problems == [], f"22(b) {label}: verify: {problems[:3]}")
    check(n_shards >= 8, f"22(b) {label}: {n_shards} shards, not >= 8")
    check(same, f"22(b) {label}: the pipelined dataset differs from the "
          "serial one")
    return {"shards": n_shards, "s": t_run, "races": 0,
            "accesses": mon.n_accesses, "states": states}


def _analysis_plans(asset_fit):
    """The chunk plans phase 22 drives, each with the sampler backend it
    runs and how often it runs each chunk: the stress runs' (twice each:
    depth 2 and depth 0) and the audit's (two passes a backend)."""
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream.scheduler import ChunkScheduler

    def demo(E):
        return KroneckerFit(*DEMO_THETA, n=ANALYSIS_N, m=ANALYSIS_N, E=E)

    audit = ChunkScheduler(demo(ANALYSIS_AUDIT_EDGES), ANALYSIS_AUDIT_SHARD,
                           seed=0)
    return [
        ("kde", ChunkScheduler(demo(ANALYSIS_EDGES), ANALYSIS_SHARD,
                               seed=0), "cuda_prng", 2),
        ("gan", ChunkScheduler(asset_fit, ANALYSIS_SHARD, seed=0),
         "cuda_prng", 2),
        ("audit", audit, "cuda_prng", 2), ("audit", audit, "cuda_bits", 2)]


def _analysis_kernels_vs_plain(plans, tr, sampler, ref, rs, torch) -> int:
    """K2 (``cuda_prng``) and K1 (``cuda_bits``) on the first chunk of
    each size in the phase's plans (the GAN plan's 4 148 chunks have 102
    sizes), each against its plain version at that chunk's shape, key and
    per-level θ.  Returns the max error."""
    err = 0
    for label, sched, backend, _ in plans:
        th = torch.tensor(sched.thetas[sched.k_pref:], dtype=torch.float32,
                          device="cuda")
        n_s, m_s = sched.fit.n - sched.k_pref, sched.fit.m - sched.k_pref
        e_plan = 0
        sizes = {ck.n_edges: ck for ck in reversed(sched.chunks)}
        for ck in sizes.values():
            key = sched.key_for(ck)
            pad = sampler._pad_edges(ck.n_edges,
                                     sampler.choose_block(ck.n_edges))
            if backend == "cuda_prng":
                got = rs.rmat_sample_prng(key, th, n_s, m_s, ck.n_edges,
                                          pad)
                want = ref.rmat_prng_ref(key, th, n_s, m_s, ck.n_edges, pad)
            else:
                bits = tr.bits(key, (max(n_s, m_s), pad), "cuda")
                got = rs.rmat_sample_bits(th, bits, n_s, m_s)
                want = ref.rmat_parts_ref(th, ref.bits_to_uniform_ref(bits),
                                          n_s, m_s)
            e_plan = max(e_plan, max_word_err(got, want))
        log(f"analysis (d) {label} ({backend}): {len(sizes)} chunk sizes "
            f"of {len(sched.chunks)} chunks, n={n_s} m={m_s}, E "
            f"{min(sizes)}-{max(sizes)}, against the plain version: "
            f"max|err| {e_plan}")
        err = max(err, e_plan)
    return err


def phase_analysis(convert, tr, sampler, ref, rs, torch) -> dict:
    """Phase 22: the port checks itself on the card.

    (a) the lint (``analysis.lint.run_lint`` over the default scope)
    against ``src/repro_torch/analysis/baseline.json``: no new finding.
    (b) two lockset stress runs at ``pipeline_depth=2`` with 2 host
    workers, K2 in the struct stage: ``analysis.races.run_stress`` (the
    KDE + random-aligner spec), and the committed asset's GAN + GBDT
    ``FeatureSpec`` through ``DatasetJob`` under ``instrument_job`` (its
    draws and alignment on the card in the pool threads): zero candidate
    races, the watched surface exercised, a dataset that verifies, shards
    equal to the same job at depth 0 on the card.  (c) the load audit
    (``analysis.retrace.run_retrace``) with ``cuda_prng`` and
    ``cuda_bits``: no ``nvcc`` start (phase 1 built everything), no load
    in steady state.  (d) K2's and K1's launches in (b)-(c) equal the
    plans' chunk counts, and each kernel equals its plain version on a
    chunk of every size in those plans.  Returns the phase's numbers
    with K1's and K2's launches and max errors."""
    import shutil
    import tempfile

    from repro_torch.analysis import baseline as baseline_mod
    from repro_torch.analysis import lint, races, retrace
    from repro_torch.datastream import DatasetJob, FeatureSpec
    from repro_torch.obs.trace import Tracer

    t_phase = time.time()
    out = {}
    t0 = time.time()
    found = lint.run_lint(ROOT)
    base = baseline_mod.load(ROOT / "src" / "repro_torch" / "analysis"
                             / "baseline.json")
    new, frozen, stale = baseline_mod.apply(found, base)
    out["lint"] = {"s": time.time() - t0, "new": len(new),
                   "baselined": len(frozen), "stale": len(stale),
                   "files": len(lint.collect_files(ROOT,
                                                   lint.DEFAULT_PATHS))}
    log(f"analysis (a): lint of {out['lint']['files']} files in "
        f"{out['lint']['s']:.2f}s: {len(new)} new, {len(frozen)} "
        f"baselined, {len(stale)} stale" + "".join(
            f"\n  {v.render()}" for v in new))
    check(not new, "22(a): new lint findings")

    pipe = convert.pipeline_from_state(convert.load_state(ASSET),
                                       device="cuda")
    fit1 = pipe.struct.scaled(1)
    plans = _analysis_plans(fit1)

    def kde(path, depth, workers):
        return races.run_stress(path, edges=ANALYSIS_EDGES,
                                shard_edges=ANALYSIS_SHARD,
                                pipeline_depth=depth, host_workers=workers,
                                device="cuda")

    def gan(path, depth, workers):
        mon = races.RaceMonitor()
        job = DatasetJob(fit1, path, shard_edges=ANALYSIS_SHARD, seed=0,
                         features=FeatureSpec(pipe.features, pipe.aligner),
                         backend="cuda_prng", pipeline_depth=depth,
                         host_workers=workers, tracer=Tracer(),
                         device="cuda")
        with races.instrument_job(mon, job):
            job.run()
        log(_stage_line(f"analysis (b) gan, depth {depth}", job.timings,
                        fit1.E))
        return mon

    work = tempfile.mkdtemp(prefix="chip_smoke_analysis_")
    torch.cuda.synchronize()
    rs.reset_launches()
    try:
        out["kde"] = _analysis_stress("kde", kde, work, torch)
        out["gan"] = _analysis_stress("gan", gan, work, torch)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    audits = {}
    for backend in ("cuda_prng", "cuda_bits"):
        rep = retrace.run_retrace(edges=ANALYSIS_AUDIT_EDGES,
                                  shard_edges=ANALYSIS_AUDIT_SHARD,
                                  backend=backend, device="cuda")
        log(f"analysis (c): {rep.render()}; counts {rep.counts}")
        check(rep.ok and rep.first_pass_builds == 0
              and rep.steady_state_loads == 0,
              f"22(c): the load audit failed: {rep.render()}")
        audits[backend] = {k: getattr(rep, k) for k in (
            "shards", "first_pass_builds", "first_pass_loads",
            "steady_state_builds", "steady_state_loads", "rebuilds",
            "constructed")}
    torch.cuda.synchronize()
    launches = dict(rs.LAUNCHES)
    out["audit"] = audits
    want = {"rmat_sample_prng": 0, "rmat_sample_bits": 0}
    for _, sched, backend, runs in plans:
        want[{"cuda_prng": "rmat_sample_prng",
              "cuda_bits": "rmat_sample_bits"}[backend]] += \
            runs * len(sched.chunks)
    log(f"analysis (d): launches in (b)-(c) {launches}; the plans' chunks "
        f"{want}")
    check(all(launches[k] == n for k, n in want.items()),
          "22(d): the kernels' launches differ from the plans' chunks")
    err = _analysis_kernels_vs_plain(plans, tr, sampler, ref, rs, torch)
    check(err == 0, f"22(d): a kernel differs from its plain version "
          f"({err})")
    del pipe
    torch.cuda.empty_cache()
    out.update(launches={k: launches[k] for k in want}, err=err,
               wall=time.time() - t_phase)
    return out


def flash_d128_timing(fa, torch) -> dict:
    """The tensor-core kernel at head dim 128 (the d = 128 template, which
    the scoring shape does not run), at the attention shape of a d = 128
    dense config at B = 4, S = 2048 (32 heads, 8 kv heads, as
    ``llama3-8b``), beside SDPA and its bound."""
    F = torch.nn.functional
    hq, hkv, s, d = LM_B * 32, LM_B * 8, LM_S, 128
    q, k, v = flash_inputs(hq, hkv, s, d, torch.bfloat16, 11, torch)

    def kern():
        return fa.flash_attention(q, k, v, causal=True, group=hq // hkv)

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True,
                                              enable_gqa=True)[0]

    check(fa.route(q.dtype, d) == "wgmma", "d = 128 left the tensor-core "
          "route")
    ms = min(cuda_ms(kern, 10), cuda_ms(kern, 10))
    lib_ms = min(cuda_ms(library, 10), cuda_ms(library, 10))
    bound_s, by = flash_bound_s(hq, hkv, s, s, d, True, "bfloat16")
    log(f"timing flash_attention at d=128 (Hq={hq} Hkv={hkv} S=T={s} causal "
        f"bf16): tensor-core kernel {ms:.4f} ms ({bound_s / ms * 1e5:.1f}% "
        f"of bound {bound_s * 1e3:.4f} ms, {by}), sdpa {lib_ms:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    return {"d128_shape": f"Hq={hq} Hkv={hkv} S=T={s} d={d} causal bf16",
            "d128_ms": ms, "d128_bound_ms": bound_s * 1e3,
            "d128_library_ms": lib_ms}


def phase_flash_timing(fa, ref, torch, launches: int, err: float) -> dict:
    """K4's tensor-core kernel, its FMA kernel on the same bf16 inputs, its
    plain version and SDPA at the scoring path's shape."""
    F = torch.nn.functional
    hq, hkv, s, d = (FLASH_PATH[k] for k in ("hq", "hkv", "s", "d"))
    group = hq // hkv
    q, k, v = flash_inputs(hq, hkv, s, d, torch.bfloat16, 7, torch)

    def kern():
        return fa.flash_attention(q, k, v, causal=True, group=group)

    def fma():
        return fa.launch(q, k, v, "fma", causal=True, group=group)

    def plain():
        return ref.attention_ref(q, k, v, causal=True, group=group)

    def library():
        return F.scaled_dot_product_attention(q[None], k[None], v[None],
                                              is_causal=True,
                                              enable_gqa=True)[0]

    check(fa.route(q.dtype, d) == "wgmma", "the path's shape left the "
          "tensor-core route")
    lib_err = attn_err(library(), plain())
    plain_ms = cuda_ms(plain, 3)
    ms = cuda_ms(kern, 20)
    fma_ms = cuda_ms(fma, 5)
    lib_ms = cuda_ms(library, 20)
    ms2 = cuda_ms(kern, 20)
    lib_ms2 = cuda_ms(library, 20)
    fma_ms2 = cuda_ms(fma, 5)
    plain_ms2 = cuda_ms(plain, 3)
    dev_us, _, kept = device_us(kern, 5)
    lib_dev_us, _, lib_kept = device_us(library, 5)
    bound_s, by = flash_bound_s(hq, hkv, s, s, d, True, "bfloat16")
    d128 = flash_d128_timing(fa, torch)
    shape = (f"Hq={hq} Hkv={hkv} S=T={s} d={d} causal bf16: the scoring "
             f"path's attention ({LM_ARCH}, B={LM_B})")
    log(f"timing flash_attention: tensor-core kernel {ms:.4f}/{ms2:.4f} ms "
        f"({bound_s / min(ms, ms2) * 1e5:.1f}% of bound), FMA kernel "
        f"{fma_ms:.4f}/{fma_ms2:.4f} ms, plain {plain_ms:.3f}/"
        f"{plain_ms2:.3f} ms, sdpa {lib_ms:.4f}/{lib_ms2:.4f} ms (max|sdpa "
        f"- plain| {lib_err:.3g}), bound {bound_s * 1e3:.4f} ms ({by}), "
        f"device per call: kernel {us_text(dev_us)} ({kept} events of 5 "
        f"calls kept), sdpa {us_text(lib_dev_us)} ({lib_kept}); {shape}")
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_wgmma.cu",
            "replaces": "src/repro/kernels/flash_attention.py:62",
            "launches": launches, "max_abs_err": err,
            "ms": min(ms, ms2), "plain_ms": min(plain_ms, plain_ms2),
            "bound_ms": bound_s * 1e3, "bound_by": by,
            "library_ms": min(lib_ms, lib_ms2),
            "device_us": dev_us, "library_device_us": lib_dev_us,
            "device_calls": 5, "device_kept": kept,
            "library_device_kept": lib_kept,
            "fma_ms": min(fma_ms, fma_ms2),
            "fma_source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "shape": shape, **d128}


#: the kernel each probe's op launches (csrc/spike_elementwise.cu,
#: csrc/spike.cu), as the profiler and cuobjdump name them
PROBE_KERNELS = {"add": "elementwise_kernel",
                 "double_blocks": "elementwise_kernel",
                 "prng_bits": "prng_vec4_kernel",
                 "column_sum": "column_sum_vec4_kernel"}
#: the probes' large shapes: S3's words, S4's (R, C)
PRNG_LARGE_WORDS = 1 << 26
COLUMN_SUM_LARGE = (64, 1 << 20)


def probe_bound_s(name: str, args, out) -> tuple:
    """Least time for a probe's work and its limiter: inputs read once
    and the output written once over HBM, against S3's threefry
    operations (``prng_bound_s``) or one float32 add or multiply per input
    element over the FMA pipes."""
    import torch
    in_bytes = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
    by_bytes = (in_bytes + out.numel() * out.element_size()) / HBM_BYTES_PER_S
    if name == "prng_bits":
        by_ops = prng_bound_s(1, out.numel())
    else:
        by_ops = args[0].numel() / PEAK_FLOPS["float32"]
    return (by_ops, "operations") if by_ops > by_bytes else (by_bytes,
                                                             "bytes")


def phase_probes_large(spike, ref, torch) -> dict:
    """S3 at ``PRNG_LARGE_WORDS`` words and S4 at ``COLUMN_SUM_LARGE``
    (one each, beyond the spike's shapes, where the bound is no longer
    the launch): each bit-equal to its plain version, timed by CUDA events
    over 20 calls (S4 in turns with ``sum(0)``, three rounds, the least of
    each) beside its bound."""
    dev = "cuda"
    gen = torch.Generator(device=dev).manual_seed(16)
    seed = torch.tensor([2026], dtype=torch.int32, device=dev)
    x = torch.randn(COLUMN_SUM_LARGE, generator=gen, device=dev)
    out = {}
    for name, kern, plain, lib, args in (
            ("prng_bits", spike.prng_bits, ref.prng_bits_ref, None,
             (seed, (PRNG_LARGE_WORDS,))),
            ("column_sum", spike.column_sum, ref.column_sum_ref,
             lambda x: x.sum(0, keepdim=True), (x,))):
        got = kern(*args)
        err = (got.double() - plain(*args).double()).abs().max().item()
        check(err == 0.0, f"probe {name} at its large shape differs from "
              f"its plain version ({err:.3g})")
        loops = [(cuda_ms(lambda: kern(*args), 20),
                  None if lib is None else cuda_ms(lambda: lib(*args), 20))
                 for _ in range(3)]
        ms = min(k for k, _ in loops)
        lib_ms = None if lib is None else min(l for _, l in loops)
        bound_s, by = probe_bound_s(name, args, got)
        dims = args[1] if name == "prng_bits" else tuple(args[0].shape)
        out[name] = {"large_shape": str(dims), "large_ms": ms,
                     "large_bound_ms": bound_s * 1e3, "large_bound_by": by,
                     "large_share": bound_s * 1e3 / ms,
                     "large_library_ms": lib_ms, "large_max_abs_err": err}
        log(f"timing probe {name} at {dims}: kernel "
            + ", ".join(f"{k:.4f}" for k, _ in loops) + " ms"
            + ("" if lib is None else ", sum(0) " + ", ".join(
                f"{l:.4f}" for _, l in loops) + " ms")
            + f"; bound {bound_s * 1e3:.4f} ms ({by}), "
            f"{bound_s * 1e3 / ms:.1%} of it"
            + ("" if lib is None else f", kernel/sum(0) {ms / lib_ms:.3f}"))
        del got
    del x
    torch.cuda.empty_cache()
    return out


def phase_probes(spike, ref, torch) -> list:
    """S1-S4 at the spike script's shapes: first on its own inputs, one
    launch each with the counters at 0 (the probes' path), then on random
    inputs of the same shapes; each held against its plain version and
    timed beside its library call (S3, which has none, beside S1's op).
    Every probe must run its torch op's kernel.  Then S3 and S4 at large
    shapes (``phase_probes_large``)."""
    dev, f32 = "cuda", torch.float32
    gen = torch.Generator().manual_seed(12)

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to(dev)

    def seed(value):
        return torch.tensor([value], dtype=torch.int32, device=dev)

    arange = torch.arange(1024, dtype=f32, device=dev).reshape(8, 128)
    # name, TPU kernel, kernel, plain version, library call (None: there is
    # none, torch.randint is Philox), the spike's inputs, random inputs
    probes = (
        ("add", "scripts/spike_pallas.py:15", spike.add, ref.add_ref,
         torch.add, (arange, arange), (rnd(8, 128), rnd(8, 128))),
        ("double_blocks", "scripts/spike_pallas.py:29", spike.double_blocks,
         ref.double_ref, lambda x: torch.mul(x, 2),
         (torch.ones((1024, 256), dtype=f32, device=dev),),
         (rnd(1024, 256),)),
        ("prng_bits", "scripts/spike_pallas.py:45", spike.prng_bits,
         ref.prng_bits_ref, None, (seed(42), (8, 128)),
         (seed(-77), (8, 128))),
        ("column_sum", "scripts/spike_pallas.py:62", spike.column_sum,
         ref.column_sum_ref, lambda x: x.sum(0, keepdim=True),
         (torch.ones((8, 128), dtype=f32, device=dev),), (rnd(8, 128),)))
    torch.cuda.synchronize()
    spike.reset_launches()
    outs = [kern(*spike_in) for _, _, kern, _, _, spike_in, _ in probes]
    torch.cuda.synchronize()
    launches = dict(spike.LAUNCHES)
    log(f"probes: the spike's shapes and inputs, launches {launches}; sums "
        f"{[float(o.float().sum()) for o in outs]}")
    loaded = {str(Path(lib).resolve()) for lib in torch.ops.loaded_libraries}
    check(str(spike.OPS_LIBRARY.path().resolve()) in loaded,
          "the probes ran without loading their torch-op library")
    bound = [str(op) for op in (spike._ADD, spike._DOUBLE, spike._PRNG,
                                spike._COLUMN_SUM)]
    check(bound == [f"repro_spike.{n}.default" for n in PROBE_KERNELS],
          f"the probes are bound to {bound}, not to their torch ops")
    rows = []
    for (name, tpu, kern, plain, lib, spike_in, args), out in zip(probes,
                                                                  outs):
        check(launches[name] == 1, f"probe {name} launched "
              f"{launches[name]} times, not once")
        err = 0.0
        for inputs, got in ((spike_in, out), (args, kern(*args))):
            want = plain(*inputs)
            check(got.dtype == want.dtype and got.shape == want.shape,
                  f"probe {name}: {got.dtype} {tuple(got.shape)} against "
                  f"{want.dtype} {tuple(want.shape)}")
            err = max(err, (got.double() - want.double()).abs().max().item())
        check(err == 0.0, f"probe {name} differs from its plain version "
              f"({err:.3g})")
        bound_s, by = probe_bound_s(name, args, out)

        def kern_call():
            return kern(*args)

        def lib_call():
            return lib(*args)

        # in turns, PROBE_ROUNDS times: kernel, library
        loops = [(cuda_ms(kern_call, 200),
                  None if lib is None else cuda_ms(lib_call, 200))
                 for _ in range(PROBE_ROUNDS)]
        ms = min(k for k, _ in loops)
        lib_ms = None if lib is None else min(l for _, l in loops)
        lib_dev_us = lib_kept = None
        lib_text = "none"
        plain_ms = min(cuda_ms(lambda: plain(*args), 200) for _ in range(2))
        dev_us, dev_names, kept = device_us(kern_call, 200)
        check(dev_names and all(PROBE_KERNELS[name] in n for n in dev_names),
              f"probe {name} ran {dev_names}, not {PROBE_KERNELS[name]}")
        if lib is not None:
            lib_dev_us, lib_names, lib_kept = device_us(lib_call, 200)
            lib_text = (f"{lib_ms * 1e3:.2f} us, device "
                        f"{us_text(lib_dev_us)} ({', '.join(lib_names)}; "
                        f"{lib_kept} events of 200 kept); kernel/library "
                        f"{ms / lib_ms:.3f} per call")
            if dev_us is not None and lib_dev_us is not None:
                lib_text += f", {dev_us / lib_dev_us:.3f} on the device"
        else:   # S3: beside S1's op, the one-launch op of the same binding
            lib_text = (f"none; kernel/S1 {ms / rows[0]['ms']:.3f} per call "
                        "in this process")
        dims = args[1] if name == "prng_bits" else tuple(args[0].shape)
        shape = (f"{dims}: the spike's shape; launch-bound, times per call "
                 "in a loop of 200")
        log(f"timing probe {name}: loops of 200 in turns, us per call "
            "(kernel, library): " + ", ".join(
                f"({k * 1e3:.2f}, {'-' if l is None else f'{l * 1e3:.2f}'})"
                for k, l in loops))
        log(f"timing probe {name}: kernel {ms * 1e3:.2f} us per call, device "
            f"{us_text(dev_us)} ({', '.join(dev_names)}; {kept} events of "
            f"200 kept); plain "
            f"{plain_ms * 1e3:.2f} us; library {lib_text}; bound "
            f"{bound_s * 1e9:.2f} ns ({by}), max|err| {err:.3g}, {shape}")
        source = ("spike_elementwise.cu" if name in ("add", "double_blocks")
                  else "spike.cu")
        rows.append({"name": f"spike_{name}", "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{source}",
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bound_s * 1e3, "bound_by": by,
                     "library_ms": lib_ms, "device_us": dev_us,
                     "library_device_us": lib_dev_us, "device_calls": 200,
                     "device_kept": kept, "library_device_kept": lib_kept,
                     "per_call_vs_library": (None if lib is None
                                             else ms / lib_ms),
                     "binding": "src/repro_torch/kernels/csrc/spike_ops.cpp"
                                f": torch.ops.repro_spike.{name}",
                     "shape": shape})
        if name == "prng_bits":
            rows[-1]["per_call_vs_add"] = ms / rows[0]["ms"]
    large = phase_probes_large(spike, ref, torch)
    for row in rows:
        row.update(large.get(row["name"][len("spike_"):], {}))
    return rows


def main() -> int:
    import os
    import shutil
    import tempfile

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card visible", file=sys.stderr)
        return 1
    from repro_torch import convert, random as tr
    from repro_torch.configs import get_config
    from repro_torch.core import rmat, sampler
    from repro_torch.core.features import GANFeatureGenerator
    from repro_torch.core.pipeline import SyntheticGraphPipeline
    from repro_torch.core.structure import KroneckerFit
    from repro_torch.data.reference import tabformer_like
    from repro_torch.graph import ops as gops
    from repro_torch.kernels import _build, ops, ref, rmat_sample as rs
    from repro_torch.kernels import flash_attention as fa, spike
    from repro_torch.models import Model, transformer
    from repro_torch.serving.engine import Request, ServingEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = gpu_line()
    t_start = t0 = time.time()
    libraries = [rs.LIBRARY, fa.LIBRARY, fa.WGMMA_LIBRARY, spike.OPS_LIBRARY]
    reports = _build.build_all(libraries)
    for name, (report, _) in reports.items():
        log(f"ptxas {name}:\n{report or 'built already'}")
    log(f"build: {time.time() - t0:.2f}s, all at once; each library "
        "(seconds from the start until its nvcc ended): " + ", ".join(
            f"{lib.path().name} {reports[lib.name][1]:.2f}s"
            for lib in libraries) + f"; card: {card}")
    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    prng_build = prng_build_facts(reports, _build, rs)
    tc_sass = sass_opcodes(read_sass(_build, fa.WGMMA_LIBRARY),
                           "flash_wgmma_kernel")
    log(f"sass: the tensor-core flash kernel, static opcode counts per "
        f"template instance: {tc_sass or 'not read'}")
    check(len(tc_sass) == 2 and all(c["HGMMA"] > 0 for c in tc_sass.values()),
          "the tensor-core flash kernel's SASS holds no HGMMA")
    probe_sass = read_sass(_build, spike.OPS_LIBRARY)
    wide = {k: sass_opcodes(probe_sass, k, ("LDG.128", "STG.128"),
                            wide_access) for k in PROBE_KERNELS.values()}
    log(f"sass: the probes' 16-byte loads and stores per kernel (S1/S2: one "
        f"template instance per op): {wide}")
    check(len(wide["elementwise_kernel"]) == 2
          and all(c["LDG.128"] > 0 and c["STG.128"] > 0
                  for c in wide["elementwise_kernel"].values()),
          "the elementwise probes' SASS holds no 16-byte loads and stores")
    check(len(wide["column_sum_vec4_kernel"]) == 1
          and all(c["LDG.128"] > 0
                  for c in wide["column_sum_vec4_kernel"].values()),
          "S4's SASS holds no 16-byte load")
    check(len(wide["prng_vec4_kernel"]) == 1
          and all(c["STG.128"] > 0
                  for c in wide["prng_vec4_kernel"].values()),
          "S3's SASS holds no 16-byte store")

    def clock(phases: str) -> None:
        log(f"clock: phases {phases} done at {time.time() - t_start:.1f}s")

    phase_rng(tr, torch)
    errs = phase_kernels(tr, ref, rs, torch)
    errs["flash_attention"], f32_err, early = phase_flash_kernel(fa, ref,
                                                                 torch)
    clock("1-3, 8 (kernels)")
    # each path runs with the counters at 0 and is read right after; each
    # kernel is also held against its plain version at the shapes its
    # path gave it
    launches = {}
    (launches["rmat_sample_prng"], e2, largest, asset_pipe,
     fid_x64) = phase_main_path(convert, tr, rmat, sampler, ref, rs, gops,
                                torch)
    clock("4, 14(a)-(b)")
    t0 = time.time()
    fidelity = phase_fidelity(asset_pipe, tr, rmat, sampler, ref, rs, torch)
    fidelity.update(x64=fid_x64, card=gpu_line())
    fidelity["walls"].update(a=fid_x64["a_s"], b=fid_x64["b_s"])
    fid_wall = sum(fidelity["walls"].values())
    log(f"fidelity: phase 14 wall {fid_wall:.1f}s of its "
        f"{FID_BUDGET_S:.0f}s budget (c-e {time.time() - t0:.1f}s); "
        + json.dumps(fidelity))
    clock("14(c)-(e)")
    fit_launches, fit_err, fit_pipe = phase_fit(
        convert, SyntheticGraphPipeline, GANFeatureGenerator, tabformer_like,
        asset_pipe, tr, rmat, sampler, ref, rs, torch)
    clock("4b")
    t0 = time.time()
    base = phase_baselines(asset_pipe, fit_pipe, tr, rmat, sampler, ref, rs,
                           torch)
    log(f"baselines: phase 15 wall {time.time() - t0:.1f}s of its "
        f"{BASE_BUDGET_S:.0f}s budget; " + json.dumps(base))
    del asset_pipe, fit_pipe
    torch.cuda.empty_cache()
    clock("15")
    launches["rmat_sample_bits"], e1 = phase_card_vs_cpu(convert, rs, torch)
    launches["rmat_sample_uniforms"], e3 = phase_narrow_ops(tr, ops, ref, rs,
                                                            torch)
    for name, e in (("rmat_sample_prng", max(e2, fit_err, fidelity["err"],
                                             base["err"])),
                    ("rmat_sample_bits", e1),
                    ("rmat_sample_uniforms", e3)):
        errs[name] = max(errs[name], e)
    phase_struct_at_scale(tr, rmat, KroneckerFit, rs, torch)
    clock("5-7")
    keep = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        trace_path = os.path.join(keep, "cli.trace.jsonl")
        path64 = os.path.join(keep, "struct64")
        stream = phase_datastream(convert, tr, rmat, sampler, ref, rs, torch,
                                  trace_path, path64)
        errs["rmat_sample_prng"] = max(errs["rmat_sample_prng"],
                                       stream["err"], stream["refit"]["err"])
        log("datastream: " + json.dumps(stream))
        clock("13")
        t0 = time.time()
        scale = phase_scaleout(path64, stream, tr, rs, torch)
        shutil.rmtree(path64)
        log(f"scale-out: phase 17 wall {time.time() - t0:.1f}s of its "
            f"{SCALE_BUDGET_S:.0f}s budget; " + json.dumps(scale))
        clock("17")
        bench = phase_benchmarks(trace_path, tr, sampler, rs, torch)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    for name in ("rmat_sample_bits", "rmat_sample_prng"):
        errs[name] = max(errs[name], bench["err"])
    log(f"benchmarks: phase 16 wall {bench['wall']:.1f}s of its "
        f"{BENCH_BUDGET_S:.0f}s budget; " + json.dumps(bench))
    clock("16")
    model, params, launches["flash_attention"], e4 = phase_lm_scoring(
        tr, get_config, Model, transformer, fa, rs, ref, torch)
    errs["flash_attention"] = max(errs["flash_attention"], e4)
    phase_serving(model, params, ServingEngine, Request, fa, torch)
    del model, params
    torch.cuda.empty_cache()
    clock("9-10")
    # phase 21's host work (the dry-run) from here on, at the lowest CPU
    # priority, on the cores phases 18-20 leave idle; stopped and removed
    # at exit, whatever happens
    plan_host = PlanHost()
    atexit.register(plan_host.close)
    train, train_k2, e_train, corpus_graph = phase_training(
        convert, tr, rmat, sampler, ref, rs, fa, get_config, Model, torch)
    errs["rmat_sample_prng"] = max(errs["rmat_sample_prng"], e_train)
    log(f"training: phase 18 wall {train['wall']:.1f}s of its "
        f"{TRAIN_BUDGET_S:.0f}s budget; " + json.dumps(train))
    clock("18")
    fam = phase_families(convert, tr, fa, ref, get_config, Model,
                         ServingEngine, Request, torch)
    errs["flash_attention"] = max(errs["flash_attention"], fam["k4_err"])
    log(f"families: phase 19 wall {fam['wall']:.1f}s of its "
        f"{FAMILY_BUDGET_S:.0f}s budget; " + json.dumps(fam))
    clock("19")
    fam_train = phase_family_training(corpus_graph, fa, tr, get_config,
                                      Model, torch)
    log(f"family training: phase 20 wall {fam_train['wall']:.1f}s of its "
        f"{FAMILY_TRAIN_BUDGET_S:.0f}s budget; " + json.dumps(fam_train))
    clock("20")
    plan, plan_k2, e_plan = phase_plan(plan_host, corpus_graph, train, tr,
                                       ref, rs, get_config, Model, torch)
    del corpus_graph
    errs["rmat_sample_prng"] = max(errs["rmat_sample_prng"], e_plan)
    log(f"plan: phase 21 wall {plan['wall']:.1f}s of its "
        f"{PLAN_BUDGET_S:.0f}s budget; " + json.dumps(plan))
    clock("21")
    analysis = phase_analysis(convert, tr, sampler, ref, rs, torch)
    for name in ("rmat_sample_prng", "rmat_sample_bits"):
        errs[name] = max(errs[name], analysis["err"])
    log(f"analysis: phase 22 wall {analysis['wall']:.1f}s of its "
        f"{ANALYSIS_BUDGET_S:.0f}s budget; " + json.dumps(analysis))
    clock("22")
    rows = phase_timing(tr, ref, rs, sampler, torch, errs, launches,
                        largest)
    rows[-1].update(prng_build)
    rows[-1].update(fit_path_launches=fit_launches,
                    fit_path_max_abs_err=fit_err,
                    streamed_launches=stream["launches"],
                    streamed_max_abs_err=stream["err"],
                    refit_path_launches=stream["refit"]["launches"],
                    refit_path_max_abs_err=stream["refit"]["err"],
                    fidelity_path_launches=fidelity["launches"],
                    fidelity_path_max_abs_err=fidelity["err"],
                    baselines_path_launches=base["launches"],
                    baselines_path_max_abs_err=base["err"],
                    scaleout_path_launches=scale["launches"],
                    scaleout_examples_launches=scale["e"]["k2"],
                    train_path_launches=train_k2,
                    train_path_max_abs_err=e_train,
                    plan_path_launches=plan_k2,
                    plan_path_max_abs_err=e_plan)
    for row in rows:
        if row["name"] in bench["launches"]:
            row.update(bench_path_launches=bench["launches"][row["name"]],
                       bench_path_max_abs_err=bench["err"])
        if row["name"] in analysis["launches"]:
            row.update(
                analysis_path_launches=analysis["launches"][row["name"]],
                analysis_path_max_abs_err=analysis["err"])
    rows.append(phase_flash_timing(fa, ref, torch,
                                   launches["flash_attention"],
                                   errs["flash_attention"]))
    rows[-1].update(families_path_launches=fam["k4_launches"],
                    families_path_max_abs_err=fam["k4_err"],
                    fma_f32_max_abs_err=f32_err,
                    early_rows_excess=early["kernel"],
                    early_rows_sdpa_excess=early["sdpa"],
                    sass_opcodes=list(tc_sass.values()))
    clock("11")
    rows += phase_probes(spike, ref, torch)
    log(f"chip_smoke: every phase passed in {time.time() - t_start:.1f}s, "
        "builds included")

    print(card, flush=True)
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
