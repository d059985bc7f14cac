"""Runtime lockset race detector for the port's datastream hot path.

A lightweight Eraser-style checker (Savage et al., "Eraser: a dynamic
data race detector for multithreaded programs"): every watched shared
variable tracks a *candidate lockset* — the locks held on every access
so far.  Each access intersects the set with the accessing thread's
currently-held locks; if a variable reaches the shared-modified state
with an empty lockset, no single lock protects it and the interleaving
is a candidate race.

Two refinements keep the executor/writer architecture from drowning the
report in benign handoffs:

* **dead-thread ownership transfer** — when every *other* thread that
  ever touched a variable has exited, the variable is re-initialized to
  EXCLUSIVE for the current thread.  This approximates the
  happens-before edge of ``Thread.join``: the executor legitimately
  reads ``AsyncFlushQueue.busy_s`` after ``close()`` joins the flush
  thread, and the writer checkpoints from the caller after teardown.
* **two-thread shared-modified rule** — a race is only reported once at
  least two *distinct* threads have accessed the variable while it is
  shared-modified.  Initialize-then-hand-off (constructor writes on the
  parent thread, worker thread takes over) never involves two live
  threads in the modified phase, so it stays quiet.

The instrumentation is zero-patching for library code: watched objects
get an in-place ``__class__`` swap (``watch_attrs``) so attribute
reads/writes report to the monitor, locks are wrapped by
``MonitoredLock`` so the held-set is tracked, and dict-shaped state
(tracer aggregates) is replaced by ``MonitoredDict``.
``run_stress`` drives a pipelined ``DatasetJob`` (``pipeline_depth>0``,
``host_workers>1``) with everything watched and must come back with
zero candidate races — that is the gate (``python -m
repro_torch.analysis.races``; on the card unless ``--device cpu``).  On
the card the struct stage launches K2 (``cuda_prng``) on the caller's
thread while the ``shard-feat`` pool threads draw features and align on
the card too; ``instrument_job`` watches any such job.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import threading
import traceback
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

# -- lockset state machine ---------------------------------------------------

VIRGIN, EXCLUSIVE, SHARED_READ, SHARED_MOD = range(4)
_STATE_NAMES = {VIRGIN: "virgin", EXCLUSIVE: "exclusive",
                SHARED_READ: "shared-read", SHARED_MOD: "shared-modified"}


@dataclasses.dataclass(frozen=True)
class Race:
    """One candidate race: the access that emptied the lockset (or the
    first shared-modified access after it) while ≥2 threads were in
    play."""
    var: str
    threads: Tuple[str, ...]
    write: bool
    location: str

    def render(self) -> str:
        kind = "write" if self.write else "read"
        return (f"RACE {self.var}: unlocked {kind} in shared-modified "
                f"state (threads: {', '.join(self.threads)}) at "
                f"{self.location}")


class _VarState:
    __slots__ = ("state", "owner", "lockset", "accessors", "sm_threads",
                 "race")

    def __init__(self) -> None:
        self.state = VIRGIN
        self.owner: Optional[threading.Thread] = None
        self.lockset: Optional[Set[str]] = None
        self.accessors: Set[threading.Thread] = set()
        self.sm_threads: Set[threading.Thread] = set()
        self.race: Optional[Race] = None


class RaceMonitor:
    """Collects accesses from instrumented objects and runs the lockset
    algorithm.  Thread-safe; one monitor per stress run."""

    def __init__(self) -> None:
        self._mu = threading.Lock()
        self._vars: Dict[str, _VarState] = {}
        self._tls = threading.local()
        self.n_accesses = 0

    # -- held-lock bookkeeping (per thread, via MonitoredLock) ---------

    def _held_counts(self) -> Dict[str, int]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = {}
        return held

    def _push_lock(self, name: str) -> None:
        held = self._held_counts()
        held[name] = held.get(name, 0) + 1

    def _pop_lock(self, name: str) -> None:
        held = self._held_counts()
        n = held.get(name, 0) - 1
        if n <= 0:
            held.pop(name, None)
        else:
            held[name] = n

    def held(self) -> Set[str]:
        return {k for k, n in self._held_counts().items() if n > 0}

    def wrap_lock(self, inner, name: str) -> "MonitoredLock":
        return MonitoredLock(self, inner, name)

    # -- the algorithm -------------------------------------------------

    def record(self, var: str, write: bool) -> None:
        t = threading.current_thread()
        held = self.held()
        with self._mu:
            self.n_accesses += 1
            v = self._vars.get(var)
            if v is None:
                v = self._vars[var] = _VarState()
            # dead-thread ownership transfer (join happens-before)
            others = [th for th in v.accessors if th is not t]
            if others and not any(th.is_alive() for th in others):
                v.state, v.owner = EXCLUSIVE, t
                v.lockset = None
                v.accessors = {t}
                v.sm_threads = set()
            v.accessors.add(t)
            if v.state == VIRGIN:
                v.state, v.owner = EXCLUSIVE, t
            elif v.state == EXCLUSIVE:
                if t is not v.owner:
                    v.lockset = set(held)
                    if write:
                        v.state = SHARED_MOD
                        v.sm_threads = {t}
                    else:
                        v.state = SHARED_READ
            elif v.state == SHARED_READ:
                v.lockset &= held
                if write:
                    v.state = SHARED_MOD
                    v.sm_threads = {t}
            else:                                   # SHARED_MOD
                v.lockset &= held
                v.sm_threads.add(t)
            if (v.state == SHARED_MOD and not v.lockset
                    and len(v.sm_threads) >= 2 and v.race is None):
                v.race = Race(
                    var=var,
                    threads=tuple(sorted(th.name for th in v.sm_threads)),
                    write=write, location=_caller_location())

    # -- results -------------------------------------------------------

    def races(self) -> List[Race]:
        with self._mu:
            return sorted((v.race for v in self._vars.values() if v.race),
                          key=lambda r: r.var)

    def state_of(self, var: str) -> str:
        """Debug/testing: the state-machine state of a watched var."""
        with self._mu:
            v = self._vars.get(var)
            return _STATE_NAMES[v.state] if v else "unwatched"

    def summary(self) -> str:
        with self._mu:
            n_vars = len(self._vars)
            n_races = sum(1 for v in self._vars.values() if v.race)
        return (f"{n_races} candidate race(s) across {n_vars} watched "
                f"variable(s), {self.n_accesses} recorded access(es)")


def _caller_location() -> str:
    """file:line of the innermost frame outside this module."""
    for frame in reversed(traceback.extract_stack()):
        if not frame.filename.endswith("races.py"):
            return f"{frame.filename}:{frame.lineno} in {frame.name}"
    return "<unknown>"


# -- instrumentation wrappers ------------------------------------------------

class MonitoredLock:
    """Wraps a ``threading.Lock``/``RLock`` so the monitor knows which
    locks each thread holds.  Context-manager and acquire/release
    compatible; everything else passes through."""

    def __init__(self, monitor: RaceMonitor, inner, name: str):
        self._monitor = monitor
        self._inner = inner
        self.name = name

    def acquire(self, *args, **kwargs) -> bool:
        got = self._inner.acquire(*args, **kwargs)
        if got:
            self._monitor._push_lock(self.name)
        return got

    def release(self) -> None:
        self._inner.release()
        self._monitor._pop_lock(self.name)

    def locked(self) -> bool:
        return self._inner.locked()

    def __enter__(self) -> "MonitoredLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class MonitoredDict(dict):
    """A dict whose reads/writes report to the monitor as accesses of a
    single logical variable (dict-shaped shared state — tracer
    aggregates — races on the *container*, not on individual keys)."""

    def __init__(self, monitor: RaceMonitor, name: str, initial=()):
        super().__init__(initial)
        self._monitor = monitor
        self._name = name

    # reads
    def __getitem__(self, k):
        self._monitor.record(self._name, write=False)
        return super().__getitem__(k)

    def get(self, k, default=None):
        self._monitor.record(self._name, write=False)
        return super().get(k, default)

    def __contains__(self, k) -> bool:
        self._monitor.record(self._name, write=False)
        return super().__contains__(k)

    def __iter__(self):
        self._monitor.record(self._name, write=False)
        return super().__iter__()

    def items(self):
        self._monitor.record(self._name, write=False)
        return super().items()

    def values(self):
        self._monitor.record(self._name, write=False)
        return super().values()

    # writes
    def __setitem__(self, k, val) -> None:
        self._monitor.record(self._name, write=True)
        super().__setitem__(k, val)

    def __delitem__(self, k) -> None:
        self._monitor.record(self._name, write=True)
        super().__delitem__(k)

    def setdefault(self, k, default=None):
        self._monitor.record(self._name, write=True)
        return super().setdefault(k, default)

    def update(self, *args, **kwargs) -> None:
        self._monitor.record(self._name, write=True)
        super().update(*args, **kwargs)

    def pop(self, *args):
        self._monitor.record(self._name, write=True)
        return super().pop(*args)

    def clear(self) -> None:
        self._monitor.record(self._name, write=True)
        super().clear()


def watch_attrs(monitor: RaceMonitor, obj: Any, attrs: Iterable[str],
                label: str) -> Any:
    """In-place instrumentation: swap ``obj.__class__`` for a subclass
    whose ``__getattribute__``/``__setattr__`` report accesses of the
    named attributes as ``label.attr``.  Returns ``obj``."""
    cls = type(obj)
    watched = frozenset(attrs)

    def __getattribute__(self, name):
        if name in watched:
            monitor.record(f"{label}.{name}", write=False)
        return object.__getattribute__(self, name)

    def __setattr__(self, name, value):
        if name in watched:
            monitor.record(f"{label}.{name}", write=True)
        cls.__setattr__(self, name, value)

    sub = type(f"_Watched_{cls.__name__}", (cls,),
               {"__getattribute__": __getattribute__,
                "__setattr__": __setattr__})
    obj.__class__ = sub
    return obj


@contextlib.contextmanager
def hook_init(cls, hook):
    """Temporarily patch ``cls.__init__`` to run ``hook(instance)``
    after construction — the way to instrument objects the pipeline
    creates internally (``ShardWriter``, ``AsyncFlushQueue``)."""
    orig = cls.__init__

    def __init__(self, *args, **kwargs):
        orig(self, *args, **kwargs)
        hook(self)

    cls.__init__ = __init__
    try:
        yield
    finally:
        cls.__init__ = orig


# -- what the datastream run watches -----------------------------------------

def instrument_feature_spec(monitor: RaceMonitor, spec) -> None:
    """Feature timing accumulators: written by ``shard-feat`` pool
    threads under the spec's lock, snapshotted by the executor."""
    spec._lock = monitor.wrap_lock(spec._lock, "FeatureSpec._lock")
    watch_attrs(monitor, spec, ("feat_s", "align_s"), "FeatureSpec")


def instrument_tracer(monitor: RaceMonitor, tracer) -> None:
    """Span aggregates: every stage on every thread records into the
    shared totals/counts dicts."""
    tracer._lock = monitor.wrap_lock(tracer._lock, "Tracer._lock")
    tracer._totals = MonitoredDict(monitor, "Tracer._totals",
                                   tracer._totals)
    tracer._counts = MonitoredDict(monitor, "Tracer._counts",
                                   tracer._counts)


def instrument_source(monitor: RaceMonitor, source) -> None:
    """The struct stage's device θ, made lazily by
    ``ChunkShardSource._suffix`` (struct-stage thread only — watched to
    prove it stays that way).  Sources without it are left alone."""
    if hasattr(source, "_suffix_dev"):
        watch_attrs(monitor, source, ("_suffix_dev",), "ChunkShardSource")


def _writer_hook(monitor: RaceMonitor):
    def hook(writer) -> None:
        watch_attrs(monitor, writer, ("_since_checkpoint",),
                    "ShardWriter")
    return hook


def _flush_hook(monitor: RaceMonitor):
    def hook(q) -> None:
        watch_attrs(monitor, q, ("busy_s", "_err"), "AsyncFlushQueue")
    return hook


@contextlib.contextmanager
def instrument_job(monitor: RaceMonitor, job):
    """Watch everything a ``DatasetJob``'s run shares across its three
    stages (struct caller thread, ``shard-feat`` pool, ``shard-flush``
    thread): its feature spec, tracer and source now, and the writer and
    flush queue it makes while the context is open."""
    from repro_torch.datastream import writer as writer_mod

    if job.features is not None:
        instrument_feature_spec(monitor, job.features)
    if job.tracer is not None:
        instrument_tracer(monitor, job.tracer)
    instrument_source(monitor, job.source)
    with hook_init(writer_mod.ShardWriter, _writer_hook(monitor)), \
            hook_init(writer_mod.AsyncFlushQueue, _flush_hook(monitor)):
        yield job


# -- the stress run ----------------------------------------------------------

def _kde_feature_spec(seed: int, device):
    """A fitted KDE + random-align feature spec (the JAX package's stress
    spec, the same numpy draws): exercises the ``shard-feat`` pool with a
    light draw per shard, on ``device``."""
    import numpy as np

    from repro_torch.core.aligner import RandomAligner
    from repro_torch.core.features import KDEFeatureGenerator
    from repro_torch.datastream.source import FeatureSpec
    from repro_torch.tabular.schema import infer_schema

    rng = np.random.default_rng(seed + 1)
    cont = rng.normal(size=(400, 2)).astype(np.float32)
    cat = rng.integers(0, 3, size=(400, 1)).astype(np.int32)
    schema = infer_schema(cont, cat)
    gen = KDEFeatureGenerator(schema, device=device).fit(cont, cat)
    return FeatureSpec(gen, RandomAligner(schema))


def run_stress(out_dir: str, *, edges: int = 40_000,
               shard_edges: int = 4096, pipeline_depth: int = 2,
               host_workers: int = 2, seed: int = 0,
               num_workers: int = 1, worker: Optional[int] = None,
               resume: bool = False,
               monitor: Optional[RaceMonitor] = None,
               device="cuda") -> RaceMonitor:
    """One fully-instrumented pipelined ``DatasetJob`` run on ``device``:
    the ``reference`` sampler on the CPU, ``cuda_prng`` (K2) on the card.

    Everything the pipeline shares across its three stages is watched;
    the run must come back with zero candidate races."""
    import torch

    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream.service import DatasetJob
    from repro_torch.obs.trace import Tracer

    device = torch.device(device)
    mon = monitor if monitor is not None else RaceMonitor()
    fit = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=12, m=12, E=edges)
    job = DatasetJob(fit, out_dir, shard_edges=shard_edges, seed=seed,
                     num_workers=num_workers,
                     features=_kde_feature_spec(seed, device),
                     backend=("cuda_prng" if device.type == "cuda"
                              else "reference"),
                     pipeline_depth=pipeline_depth,
                     host_workers=host_workers, tracer=Tracer(),
                     device=device)
    with instrument_job(mon, job):
        if resume:
            job.resume()
        else:
            job.run(worker=worker)
    return mon


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.races",
        description="lockset race detection over a pipelined DatasetJob "
                    "stress run (gate: zero candidate races)")
    ap.add_argument("--out", default=None,
                    help="dataset output dir (default: a temp dir)")
    ap.add_argument("--edges", type=int, default=40_000)
    ap.add_argument("--shard-edges", type=int, default=4096)
    ap.add_argument("--pipeline-depth", type=int, default=2)
    ap.add_argument("--host-workers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (K2 on the card, the default) or cpu")
    args = ap.parse_args(argv)

    import tempfile
    ctx = (contextlib.nullcontext(args.out) if args.out
           else tempfile.TemporaryDirectory(prefix="repro-torch-races-"))
    with ctx as out_dir:
        mon = run_stress(out_dir, edges=args.edges,
                         shard_edges=args.shard_edges,
                         pipeline_depth=args.pipeline_depth,
                         host_workers=args.host_workers, seed=args.seed,
                         device=args.device)
    races = mon.races()
    for r in races:
        print(r.render())
    print(("FAIL: " if races else "ok: ") + mon.summary())
    return 1 if races else 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
