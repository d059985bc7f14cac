"""The kernel-library load audit on the CPU: the recorder counts
``nvcc`` starts and loads, not calls, and restores what it patched; the
audit of ``ChunkShardSource`` over every shard of a small job, twice, is
ok on the CPU (no library is built or loaded there: the kernel backends
take their plain versions on CPU tensors).

There is no ``nvcc`` here, so the builds go through a stand-in compiler
(a shell script named by ``CUDA_HOME``) and the loads through libraries
whose path is torch's own ``libc10.so``."""
import ctypes
import stat
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.retrace import (BuildRecorder, RetraceReport,
                                          run_retrace)
from repro_torch.kernels import _build

LIBC10 = Path(torch.__file__).parent / "lib" / "libc10.so"


class _LoadedCuda(_build.CudaLibrary):
    """A CUDA library whose build is torch's ``libc10.so``."""

    def path(self) -> Path:
        return LIBC10


class _LoadedOps(_build.TorchOpLibrary):
    def path(self) -> Path:
        return LIBC10


def _patched():
    return (_build._Library._start, _build._Library.__init__,
            _build.CudaLibrary.lib, _build.TorchOpLibrary.load,
            _build.ctypes, torch.ops.load_library)


def test_recorder_counts_loads_not_calls_and_restores(tmp_path):
    before = _patched()
    src = tmp_path / "stub.cu"
    src.write_text("// stand-in\n")
    declared = []
    with BuildRecorder() as rec:
        cuda = _LoadedCuda(src, declared.append)
        ops = _LoadedOps([src], tmp_path / "stub_ops.cpp")
        for _ in range(3):
            assert isinstance(cuda.lib(), ctypes.CDLL)
            ops.load()
        assert _build.ctypes.c_int is ctypes.c_int
    assert len(declared) == 1
    assert rec.loads == {"stub.cu": 1, "stub.cu+stub_ops.cpp": 1}
    assert rec.builds == {} and rec.rebuilds == {}
    assert rec.constructed == ["stub.cu", "stub.cu+stub_ops.cpp"]
    assert rec.snapshot() == {"load stub.cu": 1,
                              "load stub.cu+stub_ops.cpp": 1}
    after = _patched()
    assert after[:4] == before[:4] and after[4] is ctypes
    assert "load_library" not in vars(torch.ops)
    # outside the recorder nothing counts
    _LoadedCuda(src, declared.append).lib()
    assert rec.total("loads") == 2 and len(rec.constructed) == 2


def _stand_in_nvcc(tmp_path, monkeypatch) -> Path:
    """A compiler that writes an empty file where ``-o`` says; the build
    directory under ``tmp_path``."""
    home = tmp_path / "cuda"
    (home / "bin").mkdir(parents=True)
    nvcc = home / "bin" / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then : > "$2"; fi\n'
                    '  shift\ndone\n')
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IXUSR)
    monkeypatch.setenv("CUDA_HOME", str(home))
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "build"))
    return home


def test_recorder_counts_nvcc_starts_not_builds(tmp_path, monkeypatch):
    _stand_in_nvcc(tmp_path, monkeypatch)
    src = tmp_path / "k.cu"
    src.write_text("// one kernel\n")
    with BuildRecorder() as rec:
        lib = _build._Library(src)
        for _ in range(3):
            assert lib.build().exists()
        assert rec.builds == {"k.cu": 1}
        src.write_text("// edited: a new hash, a new build\n")
        lib.build()
        logs = _build.build_all([lib, _build._Library(src)])
    assert rec.builds == {"k.cu": 2} and rec.rebuilds == {}
    assert logs == {"k.cu": ("", 0.0)}
    assert rec.constructed == ["k.cu", "k.cu"]
    assert len(list((tmp_path / "build").iterdir())) == 2   # two hashes


@pytest.mark.parametrize("backend", ["reference", "cuda_bits", "cuda_prng"])
def test_audit_on_the_cpu_is_ok(backend):
    report = run_retrace(edges=30_000, shard_edges=4096, device="cpu",
                         backend=backend)
    assert report.ok, report.render()
    assert report.shards >= 5
    assert (report.first_pass_builds, report.first_pass_loads,
            report.steady_state_builds, report.steady_state_loads,
            report.rebuilds, report.constructed) == (0, 0, 0, 0, 0, 0)
    assert report.render().startswith(f"ok: {backend} on cpu, ")


def test_audit_defaults_to_the_reference_sampler_on_the_cpu():
    assert run_retrace(edges=10_000, shard_edges=4096,
                       device="cpu").backend == "reference"


@pytest.mark.parametrize("field,value", [
    ("steady_state_builds", 1), ("steady_state_loads", 1), ("rebuilds", 1),
    ("constructed", 1), ("counts", {"load rmat_sample.cu": 2})])
def test_report_fails_on_each_broken_contract(field, value):
    fields = dict(backend="cuda_prng", device="cuda:0", shards=8,
                  first_pass_builds=1, first_pass_loads=1,
                  steady_state_builds=0, steady_state_loads=0, rebuilds=0,
                  constructed=0, counts={"nvcc rmat_sample.cu": 1,
                                         "load rmat_sample.cu": 1})
    assert RetraceReport(**fields).ok
    fields[field] = value
    report = RetraceReport(**fields)
    assert not report.ok and report.render().startswith("FAIL: ")
