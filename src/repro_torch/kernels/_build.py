"""Build and load the hand-written CUDA kernels of the port.

Each kernel source under ``csrc/`` has a plain C interface.  At first use
it is compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` of the checkout (or ``$REPRO_TORCH_BUILD``), named by a
hash of the source, the shared headers (``csrc/*.cuh``) and the flags so
that an edit rebuilds, and loaded with ``ctypes``.  ``build_all`` starts
one ``nvcc`` per source at once, so a fresh machine pays for the slowest
build, not for their sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence, Tuple

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]


def build_dir() -> Path:
    default = Path(__file__).resolve().parents[3] / "build" / "kernels"
    return Path(os.environ.get("REPRO_TORCH_BUILD", default))


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").exists():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source at first use")
    return found


class CudaLibrary:
    """One ``csrc/*.cu`` source, its compiled library and its ``ctypes``
    handle.  ``declare`` sets ``argtypes``/``restype`` of every function
    the wrapper calls."""

    def __init__(self, source: Path, declare: Callable[[ctypes.CDLL], None]):
        self.source = source
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()

    def path(self) -> Path:
        headers = sorted(self.source.parent.glob("*.cuh"))
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in (self.source, *headers))
            + " ".join(NVCC_FLAGS).encode()).hexdigest()
        return build_dir() / f"lib{self.source.stem}-{digest[:12]}.so"

    def _start(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start ``nvcc`` into a temporary file unless the library exists
        (None then)."""
        out = self.path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-Xptxas", "-v", "-o", str(tmp),
               str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True), tmp

    def _finish(self, started: Optional[Tuple[subprocess.Popen, Path]]
                ) -> str:
        if started is None:
            return ""
        proc, tmp = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {self.source.name} failed "
                               f"({proc.returncode}):\n{err}")
        os.replace(tmp, self.path())
        return err.strip()

    def build(self) -> Path:
        """Compile the source unless its library exists."""
        self._finish(self._start())
        return self.path()

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


def build_all(libraries: Sequence[CudaLibrary]) -> Dict[str, str]:
    """Compile every library whose build is missing, all ``nvcc``s at once;
    returns each source's ``-Xptxas -v`` report ('' when it was built
    already).  After every build has ended, raises if any failed."""
    started = [(lib, lib._start()) for lib in libraries]
    logs, errors = {}, []
    for lib, st in started:
        try:
            logs[lib.source.name] = lib._finish(st)
        except RuntimeError as exc:
            errors.append(str(exc))
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs
