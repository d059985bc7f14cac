"""Static analysis and runtime correctness harnesses for the port's
recurring bug classes.

* :mod:`repro_torch.analysis.lint` — AST lint pass (``python -m
  repro_torch.analysis.lint``) with the port's checkers (DET01 hidden
  constant-seed RNG, numpy's, the stdlib's and torch's global generator,
  MUT01 shared-mutable defaults, OVF01 unguarded node-id shifts, TRC01 a
  kernel library built or loaded per call, OBS01 hot-path stages missing
  a tracer span, DEAD01 registered-but-never-exercised sampler backends)
  and a checked-in baseline (``src/repro_torch/analysis/baseline.json``)
  that freezes existing debt — new violations fail the gate.
* :mod:`repro_torch.analysis.races` — a lightweight Eraser-style lockset
  race detector: instrumentation wrappers for the executor/writer shared
  state (stage timers, flush queue, the struct stage's device θ, tracer
  aggregates) record per-thread accesses with the held-lock set and
  report candidate races; driven by a pipelined ``DatasetJob`` stress run
  on the card (or the CPU).
* :mod:`repro_torch.analysis.retrace` — the kernel-library load audit:
  over a multi-shard run, no library is built while the build directory
  holds it, each is loaded at most once a process, and a second pass over
  the same shards builds and loads nothing (the contract TRC01 checks
  statically).
"""
from repro_torch.analysis.checkers import Violation, all_checkers  # noqa: F401
