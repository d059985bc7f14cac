"""Optional ``torch.profiler`` bracketing for device-side attribution.

Host-side spans time *launches*, not device execution: a CUDA launch
returns before the kernel finishes, so a wall-clock span around it
under-reports device time (or over-reports when a later copy to the host
pays for it).  When a run is started with ``--torch-profile DIR``, the
pipeline additionally:

* runs a ``torch.profiler`` session over the run (CPU and, where a card
  is visible, CUDA activity) and writes its Chrome trace into ``DIR``
  (open it in Perfetto or ``chrome://tracing``), and
* brackets the hot path's device work — the shard sources' chunk
  launches, fused shard programs and device steps — with
  ``torch.profiler.record_function`` ranges, so kernels correlate back
  to pipeline stages by name.

Everything is a no-op when profiling is off (the common case):
``annotation()`` returns a shared null context, so instrumented code pays
one call and one truthiness check.
"""
from __future__ import annotations

import contextlib
import os
import sys
import threading
from typing import Optional

__all__ = ["annotation", "start", "stop", "trace", "profiling"]

_lock = threading.Lock()
_active_dir: Optional[str] = None
_prof = None


class _NullCtx:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None


_NULL = _NullCtx()


def profiling() -> bool:
    return _active_dir is not None


def annotation(name: str):
    """A ``torch.profiler.record_function(name)`` while a profile is
    active, else a shared no-op context."""
    if _active_dir is None:
        return _NULL
    import torch
    return torch.profiler.record_function(name)


def start(log_dir: str) -> bool:
    """Begin a profile whose trace lands in ``log_dir``.  Returns True
    once the session runs (already running counts)."""
    global _active_dir, _prof
    with _lock:
        if _active_dir is not None:
            return True
        import torch
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.__enter__()
        _prof, _active_dir = prof, log_dir
        return True


def stop() -> Optional[str]:
    """End the profile and write ``trace.json`` into its directory;
    returns that path (or None when no profile ran)."""
    global _active_dir, _prof
    with _lock:
        if _active_dir is None:
            return None
        prof, log_dir = _prof, _active_dir
        _prof, _active_dir = None, None
    prof.__exit__(None, None, None)
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    print(f"torch profile: {path}", file=sys.stderr)
    return path


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Context form: profile the body when ``log_dir`` is set."""
    started = start(log_dir) if log_dir else False
    try:
        yield started
    finally:
        if started:
            stop()
