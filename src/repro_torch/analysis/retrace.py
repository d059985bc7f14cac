"""Kernel-library load audit: prove the port builds and loads each
library once.

The port traces and compiles nothing per call: its kernels are shared
libraries that ``kernels/_build`` compiles with ``nvcc`` at first use
(named by a hash of their sources and flags) and loads once a process.
TRC01 (the static rule) checks that no library is made or loaded inside
a function that runs per call; this harness proves the *dynamic* half of
the contract over a multi-shard run: no ``nvcc`` starts for a library the
build directory already holds, each library is loaded at most once, and
a second pass over the same shards builds and loads **nothing** — steady
state means zero builds and zero loads.

Mechanism: ``BuildRecorder`` temporarily wraps ``_Library._start`` (an
``nvcc`` start when it returns a process), ``_Library.__init__``, and the
loaders themselves — ``ctypes.CDLL`` as ``kernels/_build`` sees it
(``CudaLibrary.lib``) and ``torch.ops.load_library``
(``TorchOpLibrary.load``) — so a call that finds its library loaded
counts nothing: loads, not calls.

``python -m repro_torch.analysis.retrace`` runs ``ChunkShardSource`` over
every shard of a small job twice (on the card unless ``--device cpu``)
and fails if the audit does not hold.
"""
from __future__ import annotations

import argparse
import ctypes
import dataclasses
import threading
from typing import Dict, List, Optional


class _CtypesView:
    """``ctypes`` as ``kernels/_build`` sees it while recording: every
    name passes through but ``CDLL``, which counts."""

    def __init__(self, CDLL):
        self.CDLL = CDLL

    def __getattr__(self, name):
        return getattr(ctypes, name)


class BuildRecorder:
    """Context manager: while active, counts per kernel library (its
    ``_Library.name``) the ``nvcc`` starts, the starts made although the
    build directory already held the library, the loads, and the
    ``_Library`` objects constructed.  Restores everything on exit."""

    def __init__(self) -> None:
        self.builds: Dict[str, int] = {}
        self.rebuilds: Dict[str, int] = {}
        self.loads: Dict[str, int] = {}
        self._made: List = []
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._undo: List = []

    def _bump(self, table: Dict[str, int], label: str) -> None:
        with self._mu:
            table[label] = table.get(label, 0) + 1

    @property
    def constructed(self) -> List[str]:
        """The names of the ``_Library`` objects made while recording."""
        with self._mu:
            return [lib.name for lib in self._made]

    def total(self, table: str) -> int:
        with self._mu:
            return sum(getattr(self, table).values())

    def snapshot(self) -> Dict[str, int]:
        """Every count as ``"<kind> <library>"``."""
        with self._mu:
            return {f"{kind} {label}": n
                    for kind, table in (("nvcc", self.builds),
                                        ("rebuild", self.rebuilds),
                                        ("load", self.loads))
                    for label, n in table.items()}

    def _patch(self, obj, name: str, value) -> None:
        had = name in vars(obj)
        self._undo.append((obj, name, had, getattr(obj, name)))
        setattr(obj, name, value)

    def _loading(self, method):
        """``method`` with the library it runs for named to the loaders
        it reaches (on this thread)."""
        tls = self._tls

        def wrapped(lib, *args, **kwargs):
            outer = getattr(tls, "lib", None)
            tls.lib = lib.name
            try:
                return method(lib, *args, **kwargs)
            finally:
                tls.lib = outer
        return wrapped

    def _counting(self, loader):
        rec = self

        def load(path, *args, **kwargs):
            rec._bump(rec.loads, getattr(rec._tls, "lib", None) or str(path))
            return loader(path, *args, **kwargs)
        return load

    def __enter__(self) -> "BuildRecorder":
        import torch

        from repro_torch.kernels import _build

        rec = self
        lib_cls = _build._Library
        orig_start, orig_init = lib_cls._start, lib_cls.__init__

        def _start(lib):
            held = lib.path().exists()
            started = orig_start(lib)
            if started is not None:
                rec._bump(rec.builds, lib.name)
                if held:
                    rec._bump(rec.rebuilds, lib.name)
            return started

        def __init__(lib, *args, **kwargs):
            orig_init(lib, *args, **kwargs)
            with rec._mu:
                rec._made.append(lib)

        self._patch(lib_cls, "_start", _start)
        self._patch(lib_cls, "__init__", __init__)
        self._patch(_build.CudaLibrary, "lib",
                    self._loading(_build.CudaLibrary.lib))
        self._patch(_build.TorchOpLibrary, "load",
                    self._loading(_build.TorchOpLibrary.load))
        self._patch(_build, "ctypes",
                    _CtypesView(self._counting(ctypes.CDLL)))
        self._patch(torch.ops, "load_library",
                    self._counting(torch.ops.load_library))
        return self

    def __exit__(self, *exc) -> None:
        while self._undo:
            obj, name, had, value = self._undo.pop()
            if had:
                setattr(obj, name, value)
            else:
                delattr(obj, name)


@dataclasses.dataclass
class RetraceReport:
    backend: str
    device: str
    shards: int                   # shards generated in each pass
    first_pass_builds: int        # nvcc starts, pass 1
    first_pass_loads: int         # library loads, pass 1
    steady_state_builds: int      # NEW nvcc starts, pass 2
    steady_state_loads: int       # NEW loads, pass 2
    rebuilds: int                 # starts while the build dir held it
    constructed: int              # _Library objects made during the run
    counts: Dict[str, int]        # per "<kind> <library>", both passes

    @property
    def max_loads(self) -> int:
        """The most loads of one library over both passes."""
        return max((n for k, n in self.counts.items()
                    if k.startswith("load ")), default=0)

    @property
    def ok(self) -> bool:
        return (self.rebuilds == 0 and self.max_loads <= 1
                and self.steady_state_builds == 0
                and self.steady_state_loads == 0
                and self.constructed == 0)

    def render(self) -> str:
        status = "ok" if self.ok else "FAIL"
        return (f"{status}: {self.backend} on {self.device}, "
                f"{self.shards} shard(s) twice: {self.first_pass_builds} "
                f"nvcc start(s) and {self.first_pass_loads} load(s) in "
                f"pass 1, {self.steady_state_builds} and "
                f"{self.steady_state_loads} in steady state, "
                f"{self.rebuilds} rebuild(s) of a built library, at most "
                f"{self.max_loads} load(s) of one library, "
                f"{self.constructed} library object(s) made")


def run_retrace(*, edges: int = 60_000, shard_edges: int = 8192,
                seed: int = 0, backend: Optional[str] = None,
                device="cuda") -> RetraceReport:
    """Drive ``ChunkShardSource`` over every shard twice on ``device``
    (``backend`` None: ``cuda_prng`` on the card, ``reference`` on the
    CPU) and audit the builds and loads."""
    import numpy as np
    import torch

    from repro_torch.core.structure import KroneckerFit
    from repro_torch.datastream.scheduler import ChunkScheduler
    from repro_torch.datastream.source import ChunkShardSource

    device = torch.device(device)
    if backend is None:
        backend = "cuda_prng" if device.type == "cuda" else "reference"
    fit = KroneckerFit(a=0.45, b=0.22, c=0.2, d=0.13, n=12, m=12,
                       E=edges)
    sched = ChunkScheduler(fit, shard_edges=shard_edges, seed=seed)
    with BuildRecorder() as rec:
        source = ChunkShardSource(sched, backend, np.int32, device=device)
        for sh in sched.shards:
            source.generate(sh)
        builds, loads = rec.total("builds"), rec.total("loads")
        for sh in sched.shards:          # steady state: nothing new
            source.generate(sh)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    return RetraceReport(
        backend=backend, device=str(device), shards=len(sched.shards),
        first_pass_builds=builds, first_pass_loads=loads,
        steady_state_builds=rec.total("builds") - builds,
        steady_state_loads=rec.total("loads") - loads,
        rebuilds=rec.total("rebuilds"), constructed=len(rec.constructed),
        counts=rec.snapshot())


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.retrace",
        description="kernel-library load audit of the chunk shard source "
                    "(gate: no rebuild, one load a library, nothing new "
                    "in steady state)")
    ap.add_argument("--edges", type=int, default=60_000)
    ap.add_argument("--shard-edges", type=int, default=8192)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu")
    ap.add_argument("--backend", default=None,
                    help="sampler backend (default: cuda_prng on the card, "
                         "reference on the CPU)")
    args = ap.parse_args(argv)

    report = run_retrace(edges=args.edges, shard_edges=args.shard_edges,
                         seed=args.seed, backend=args.backend,
                         device=args.device)
    for label, n in sorted(report.counts.items()):
        print(f"  {n:3d}  {label}")
    print(report.render())
    return 0 if report.ok else 1


if __name__ == "__main__":
    import sys
    sys.exit(main())
