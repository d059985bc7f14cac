"""Worker-process launcher for multi-process dataset generation.

:class:`WorkerProcess` wraps one spawned stripe worker: it builds the
environment (``PYTHONPATH`` led by the ``src`` directory this
``repro_torch`` was imported from, so the child runs the same code),
redirects the child's stdout/stderr to ``worker.w{k}.log`` next to the
dataset, and **tails the worker's journal incrementally** —
``poll_journal()`` reads only the bytes appended since the last poll and
only up to the last complete line, so a record the worker is mid-append
on is never half-parsed (the next poll picks it up whole).  The
coordinator in :mod:`repro_torch.distributed.cluster` drives these;
nothing here knows about shards beyond "a journal line is one JSON
object".
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["WorkerProcess", "python_argv", "repro_torch_pythonpath",
           "worker_env", "worker_log_name"]


def repro_torch_pythonpath() -> str:
    """The ``src`` directory the running ``repro_torch`` package was
    imported from — prepended to the child's ``PYTHONPATH`` so spawned
    workers resolve the same code as the coordinator."""
    import repro_torch
    init = getattr(repro_torch, "__file__", None)
    if init:
        return os.path.dirname(os.path.dirname(os.path.abspath(init)))
    # namespace package (no __init__.py): __path__ holds the package dir
    return os.path.dirname(os.path.abspath(list(repro_torch.__path__)[0]))


def worker_env(**overrides: str) -> Dict[str, str]:
    """The environment a spawned ``repro_torch`` process runs in: this
    one's, ``PYTHONPATH`` led by :func:`repro_torch_pythonpath`, then
    ``overrides``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repro_torch_pythonpath()]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env.update(overrides)
    return env


def worker_log_name(worker_id: int) -> str:
    return f"worker.w{int(worker_id)}.log"


def python_argv(*args: str) -> List[str]:
    """``[sys.executable, *args]`` — e.g. ``python_argv("-m",
    "repro_torch.scripts.generate_dataset", ...)``."""
    return [sys.executable, *args]


class WorkerProcess:
    """One spawned worker stripe: process handle + incremental journal
    tail.

    ``argv`` is the full command line (typically ``python -m
    repro_torch.scripts.generate_dataset ... --worker-id k``).  The
    journal at ``journal_path`` need not exist yet — the worker creates
    it on its first committed shard.
    """

    def __init__(self, worker_id: int, argv: Sequence[str],
                 journal_path: str, log_dir: Optional[str] = None):
        self.worker_id = int(worker_id)
        self.argv = list(argv)
        self.journal_path = journal_path
        self._offset = 0          # bytes of journal already consumed
        self._carry = b""         # partial line awaiting its newline
        self.log_path: Optional[str] = None
        self._log_file = None
        stdout = subprocess.DEVNULL
        if log_dir is not None:
            self.log_path = os.path.join(
                log_dir, worker_log_name(self.worker_id))
            self._log_file = open(self.log_path, "ab")
            stdout = self._log_file
        self.proc = subprocess.Popen(
            self.argv, stdout=stdout, stderr=subprocess.STDOUT,
            env=worker_env())

    # -- lifecycle ---------------------------------------------------------
    def alive(self) -> bool:
        return self.proc.poll() is None

    @property
    def returncode(self) -> Optional[int]:
        return self.proc.poll()

    def kill(self) -> None:
        """SIGKILL the worker and reap it.  Used by the coordinator on
        shutdown, on a stalled worker and by the fault-injection path."""
        try:
            if self.alive():
                self.proc.kill()
            self.proc.wait()
        finally:
            self._close_log()

    def wait(self, timeout: Optional[float] = None) -> Optional[int]:
        try:
            rc = self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            return None
        self._close_log()
        return rc

    def _close_log(self) -> None:
        if self._log_file is not None:
            try:
                self._log_file.close()
            finally:
                self._log_file = None

    # -- journal tail ------------------------------------------------------
    def poll_journal(self) -> List[Dict[str, Any]]:
        """New complete journal records since the last poll.

        Reads from the saved byte offset; bytes after the last ``\\n``
        are carried over rather than parsed, so a record being appended
        when we read is deferred, never torn.  Corrupt complete lines
        (each journal has one writer, so they should not occur) are
        skipped.
        """
        try:
            with open(self.journal_path, "rb") as f:
                f.seek(self._offset)
                chunk = f.read()
        except OSError:
            return []
        if not chunk:
            return []
        self._offset += len(chunk)
        data = self._carry + chunk
        head, sep, tail = data.rpartition(b"\n")
        if not sep:                       # no newline yet: all carry
            self._carry = data
            return []
        self._carry = tail
        out: List[Dict[str, Any]] = []
        for line in head.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line.decode("utf-8"))
            except (ValueError, UnicodeDecodeError):
                continue
            if isinstance(rec, dict):
                out.append(rec)
        return out

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        state = "alive" if self.alive() else f"rc={self.returncode}"
        return f"WorkerProcess(w{self.worker_id}, {state})"
