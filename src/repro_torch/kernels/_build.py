"""Build and load the hand-written CUDA kernels of the port.

Two kinds of library, both compiled at first use with ``nvcc`` for
``sm_90a`` into ``build/kernels/`` of the checkout (or
``$REPRO_TORCH_BUILD``), each named by a hash of its sources, the shared
headers (``csrc/*.cuh``) and the flags so that an edit rebuilds:

* ``CudaLibrary``: one ``csrc/*.cu`` with a plain C interface, loaded
  with ``ctypes``;
* ``TorchOpLibrary``: ``.cu`` sources of kernels and a ``.cpp`` that
  registers them as torch ops (``TORCH_LIBRARY``), linked against torch's
  own libraries and loaded with ``torch.ops.load_library``.  The binding
  includes only torch's core headers, never ``torch/extension.h``, so the
  host compiler takes seconds on it; its hash also covers torch's version
  and C++ ABI, so a new torch rebuilds it.

``build_all`` starts one ``nvcc`` per library at once, so a fresh machine
pays for the slowest build, not for their sum.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]
#: the torch-op libraries: C++20, the standard that torch.utils.cpp_extension
#: compiles torch's headers with
NVCC_FLAGS_TORCH = [f.replace("c++17", "c++20") for f in NVCC_FLAGS]


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


class _Library:
    """Sources compiled by one ``nvcc`` into one shared library."""

    def __init__(self, source: Path):
        self.source = source
        self.name, self.stem = source.name, source.stem
        self._lock = threading.Lock()

    def sources(self) -> Tuple[Path, ...]:
        return (self.source,)

    def flags(self) -> List[str]:
        return NVCC_FLAGS

    def stamp(self) -> str:
        """What else the build depends on, hashed with sources and flags."""
        return ""

    def path(self) -> Path:
        headers = sorted(self.source.parent.glob("*.cuh"))
        digest = hashlib.sha256(
            b"".join(p.read_bytes() for p in (*self.sources(), *headers))
            + (" ".join(self.flags()) + self.stamp()).encode()).hexdigest()
        return build_dir() / f"lib{self.stem}-{digest[:12]}.so"

    def _start(self) -> Optional[Tuple[subprocess.Popen, Path]]:
        """Start ``nvcc`` into a temporary file unless the library exists
        (None then)."""
        out = self.path()
        if out.exists():
            return None
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *self.flags(), "-Xptxas", "-v", "-o", str(tmp),
               *map(str, self.sources())]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True), tmp

    def _finish(self, started: Optional[Tuple[subprocess.Popen, Path]]
                ) -> str:
        if started is None:
            return ""
        proc, tmp = started
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {self.name} failed "
                               f"({proc.returncode}):\n{err}")
        os.replace(tmp, self.path())
        return err.strip()

    def build(self) -> Path:
        """Compile the sources unless their library exists."""
        self._finish(self._start())
        return self.path()


class CudaLibrary(_Library):
    """One ``csrc/*.cu`` source with a plain C interface, its compiled
    library and its ``ctypes`` handle.  ``declare`` sets
    ``argtypes``/``restype`` of every function the wrapper calls."""

    def __init__(self, source: Path, declare: Callable[[ctypes.CDLL], None]):
        super().__init__(source)
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None

    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib


class TorchOpLibrary(_Library):
    """``.cu`` sources of kernels with ``extern "C"`` launchers and the
    ``.cpp`` binding that registers them as torch ops, linked by one
    ``nvcc`` into ``lib<binding stem>-<hash>.so`` against torch's ``c10``,
    ``c10_cuda``, ``torch_cpu`` and ``torch_cuda``.  ``load`` builds the
    library if it is missing and loads it once; the ops are then
    ``torch.ops.<namespace>.<name>``."""

    def __init__(self, kernels: Sequence[Path], binding: Path):
        super().__init__(binding)
        self.kernels = tuple(kernels)
        self.name = "+".join(p.name for p in (*self.kernels, binding))
        self._loaded = False

    def sources(self) -> Tuple[Path, ...]:
        return (*self.kernels, self.source)

    def flags(self) -> List[str]:
        import torch
        from torch.utils import cpp_extension
        abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
        libs = cpp_extension.library_paths()
        return [*NVCC_FLAGS_TORCH, f"-D_GLIBCXX_USE_CXX11_ABI={abi}",
                *(f"-I{p}" for p in cpp_extension.include_paths()),
                *(f"-L{p}" for p in libs), "-lc10", "-lc10_cuda",
                "-ltorch_cpu", "-ltorch_cuda",
                *(f"-Xlinker=-rpath={p}" for p in libs)]

    def stamp(self) -> str:
        import torch
        return torch.__version__

    def load(self) -> None:
        import torch
        with self._lock:
            if not self._loaded:
                torch.ops.load_library(str(self.build()))
                self._loaded = True


def build_all(libraries: Sequence[_Library]
              ) -> Dict[str, Tuple[str, float]]:
    """Compile every library whose build is missing, all ``nvcc``s at once;
    returns each library's ``-Xptxas -v`` report and the seconds from the
    start until its build ended ('' and 0.0 when it was built already).
    After every build has ended, raises if any failed."""
    t0 = time.perf_counter()
    started = [(lib, lib._start()) for lib in libraries]
    logs: Dict[str, Tuple[str, float]] = {}
    errors = []

    def finish(lib: _Library, st) -> None:
        try:
            report = lib._finish(st)
            logs[lib.name] = (report, 0.0 if st is None
                              else time.perf_counter() - t0)
        except RuntimeError as exc:
            errors.append(str(exc))

    threads = [threading.Thread(target=finish, args=a) for a in started]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs
