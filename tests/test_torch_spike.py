"""The port's toolchain probes against the Pallas probes they replace.

``scripts/spike_pallas.py`` holds the four Pallas kernels S1–S4; the test
takes their bodies from the script itself (``runpy``) and runs them in
interpret mode on numpy-made inputs, which the port's ``kernels.spike``
wrappers get too.  On a CPU the wrappers take their plain versions; the
CUDA kernels are held against those in ``test_torch_cuda.py``.  S1 and
S2 must match exactly, S4 within 1e-6 (both sides add the rows in order,
in float32).  S3's TPU kernel draws the TPU's hardware bits, which no CPU
or CUDA card reproduces (it fails in interpret mode on a CPU), so its
counterpart is held to ``jax.random.bits`` of the same seed instead.

S1–S4 on the card are torch ops of one library built from
``csrc/spike_elementwise.cu``, ``csrc/spike.cu`` and ``csrc/spike_ops.cpp``;
this CPU never builds or loads it.  What the CPU can check is the
wrappers' CUDA branch, on a stand-in for a CUDA tensor: straight to the
op, one count per call, no Python device guard, no ``ctypes``, no fallback
to the plain version; and the library's sources, build flags and headers.
"""
import re
import runpy
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro_torch.kernels import _build, spike

SCRIPT = Path(__file__).resolve().parents[1] / "scripts" / "spike_pallas.py"


@pytest.fixture(scope="module")
def probes():
    """The script's namespace: running it defines the kernel bodies."""
    return runpy.run_path(str(SCRIPT))


def _normal(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.mark.parametrize("shape,seed", [((8, 128), 0), ((8, 128), 1),
                                        ((16, 256), 2)])
def test_add_matches_pallas(probes, shape, seed):
    x, y = _normal(shape, seed), _normal(shape, seed + 100)
    want = pl.pallas_call(
        probes["add_kernel"],
        out_shape=jax.ShapeDtypeStruct(shape, jnp.float32),
        interpret=True)(jnp.asarray(x), jnp.asarray(y))
    got = spike.add(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows,cols", [(1024, 256), (256, 128)])
def test_double_blocks_matches_pallas(probes, rows, cols):
    x = _normal((rows, cols), rows)
    spec = pl.BlockSpec((128, cols), lambda i: (i, 0))
    want = pl.pallas_call(
        probes["blk_kernel"],
        out_shape=jax.ShapeDtypeStruct((rows, cols), jnp.float32),
        grid=(rows // 128,), in_specs=[spec], out_specs=spec,
        interpret=True)(jnp.asarray(x))
    got = spike.double_blocks(torch.from_numpy(x), block_rows=128)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("rows", [8, 64])
def test_column_sum_matches_pallas(probes, rows):
    x = _normal((rows, 128), rows)
    want = pl.pallas_call(
        probes["loop_kernel"],
        out_shape=jax.ShapeDtypeStruct((1, 128), jnp.float32),
        interpret=True)(jnp.asarray(x))
    got = spike.column_sum(torch.from_numpy(x))
    assert tuple(got.shape) == (1, 128)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-6


@pytest.mark.parametrize("seed", [42, 0, -7, 2 ** 31 - 1])
@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 7)])
def test_prng_bits_is_jax_random_bits(seed, shape):
    want = np.asarray(jax.random.bits(jax.random.PRNGKey(seed), shape))
    got = spike.prng_bits(torch.tensor([seed], dtype=torch.int32), shape)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


@pytest.mark.parametrize("call,match", [
    (lambda: spike.add(torch.zeros(8, 128), torch.zeros(8, 64)),
     "one shape"),
    (lambda: spike.add(torch.zeros(8, 128, dtype=torch.float64),
                       torch.zeros(8, 128, dtype=torch.float64)), "float32"),
    (lambda: spike.double_blocks(torch.zeros(200, 128)), "multiple"),
    (lambda: spike.column_sum(torch.zeros(8, 128).t()), "contiguous"),
    (lambda: spike.prng_bits(torch.tensor([1, 2], dtype=torch.int32),
                             (8, 128)), "one int32"),
    (lambda: spike.prng_bits(torch.tensor([1]), (8, 128)), "int32"),
    (lambda: spike.prng_bits(torch.ones((1, 1), dtype=torch.int32), (8,)),
     "1-d"),
    (lambda: spike.prng_bits(torch.tensor([1], dtype=torch.int32),
                             (8, -1)), "negative"),
    (lambda: spike.column_sum(torch.zeros(128)), "2-d"),
    (lambda: spike.column_sum(torch.zeros(8, 128, dtype=torch.float64)),
     "float32"),
])
def test_probes_reject_what_the_kernels_do_not_take(call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_cpu_calls_launch_no_kernel():
    spike.reset_launches()
    x = torch.ones(128, 128)
    spike.add(x, x)
    spike.double_blocks(x)
    spike.column_sum(x)
    spike.prng_bits(torch.tensor([3], dtype=torch.int32), (4,))
    assert sum(spike.LAUNCHES.values()) == 0


class _CudaStandIn:
    """What the CUDA branch of a probe may read of a CUDA tensor before it
    hands it to the op."""
    is_cuda = True

    def __init__(self, *shape):
        self.shape = torch.Size(shape)

    def dim(self):
        return len(self.shape)


def _refuse(*args, **kwargs):
    raise AssertionError("the CUDA branch left the torch op")


PLAIN_VERSIONS = ("add_ref", "double_ref", "prng_bits_ref",
                  "column_sum_ref")


@pytest.fixture
def op_calls(monkeypatch):
    """The ops replaced by recorders; the Python device guard, the
    current-stream lookup and the plain versions replaced by failures.
    The module has no ctypes library left to replace."""
    assert not hasattr(spike, "LIBRARY") and not hasattr(spike, "ctypes")
    calls = []
    monkeypatch.setattr(spike, "_ADD",
                        lambda x, y: calls.append(("add", x, y)) or "sum")
    monkeypatch.setattr(spike, "_DOUBLE",
                        lambda x: calls.append(("double_blocks", x))
                        or "twice")
    monkeypatch.setattr(spike, "_PRNG",
                        lambda seed, shape: calls.append(
                            ("prng_bits", seed, shape)) or "bits")
    monkeypatch.setattr(spike, "_COLUMN_SUM",
                        lambda x: calls.append(("column_sum", x)) or "sums")
    for obj, attr in ((torch.cuda, "device"), (torch.cuda, "current_stream"),
                      *((spike.ref, f) for f in PLAIN_VERSIONS)):
        monkeypatch.setattr(obj, attr, _refuse)
    spike.reset_launches()
    return calls


def _probe_calls():
    """name → (the call on stand-ins, what its op gets, what it returns)"""
    x, y = _CudaStandIn(8, 128), _CudaStandIn(8, 128)
    big, seed = _CudaStandIn(1024, 256), _CudaStandIn(1)
    return {
        "add": (lambda: spike.add(x, y), ("add", x, y), "sum"),
        "double_blocks": (lambda: spike.double_blocks(big),
                          ("double_blocks", big), "twice"),
        "prng_bits": (lambda: spike.prng_bits(seed, (8, 128)),
                      ("prng_bits", seed, (8, 128)), "bits"),
        "column_sum": (lambda: spike.column_sum(x), ("column_sum", x),
                       "sums"),
    }


@pytest.mark.parametrize("calls_per_probe", [1, 3])
@pytest.mark.parametrize("name", list(spike.LAUNCHES))
def test_cuda_branch_goes_straight_to_the_op(op_calls, name,
                                             calls_per_probe):
    call, recorded, result = _probe_calls()[name]
    for _ in range(calls_per_probe):
        assert call() == result
    assert op_calls == [recorded] * calls_per_probe
    assert spike.LAUNCHES == {k: calls_per_probe if k == name else 0
                              for k in spike.LAUNCHES}


def test_spike_module_binds_no_ctypes_library():
    """Every probe goes through the one torch-op library; the module
    imports no ``ctypes`` and keeps no ctypes library or launcher."""
    text = Path(spike.__file__).read_text()
    assert not re.search(r"^\s*(import|from)\s+ctypes", text, re.M)
    for attr in ("LIBRARY", "_declare", "_launch", "ctypes"):
        assert not hasattr(spike, attr), attr
    assert [p.name for p in spike.OPS_LIBRARY.sources()] == [
        "spike_elementwise.cu", "spike.cu", "spike_ops.cpp"]


@pytest.mark.parametrize("shape,block_rows", [((200, 128), 128),
                                              ((256, 128), 0),
                                              ((1024, 256), 100)])
def test_cuda_branch_keeps_the_row_block_contract(op_calls, shape,
                                                  block_rows):
    with pytest.raises(ValueError, match="multiple"):
        spike.double_blocks(_CudaStandIn(*shape), block_rows=block_rows)
    assert op_calls == [] and spike.LAUNCHES["double_blocks"] == 0


@pytest.mark.parametrize("name", list(spike.LAUNCHES))
def test_cuda_branch_raises_when_the_ops_do_not_load(monkeypatch, name):
    """A library that does not build raises; the plain version is never
    taken for a CUDA tensor."""
    def no_nvcc():
        raise RuntimeError("nvcc not found")
    for attr in ("_ADD", "_DOUBLE", "_PRNG", "_COLUMN_SUM"):
        monkeypatch.setattr(spike, attr, None)
    monkeypatch.setattr(spike.OPS_LIBRARY, "load", no_nvcc)
    for attr in PLAIN_VERSIONS:
        monkeypatch.setattr(spike.ref, attr, _refuse)
    spike.reset_launches()
    call, _, _ = _probe_calls()[name]
    with pytest.raises(RuntimeError, match="nvcc"):
        call()
    assert sum(spike.LAUNCHES.values()) == 0


#: what the op library's build reads: its sources and the shared headers
OP_LIBRARY_FILES = ("spike_elementwise.cu", "spike.cu", "spike_ops.cpp",
                    "grid.cuh", "threefry.cuh")


def _op_library_at(d):
    return _build.TorchOpLibrary((d / "spike_elementwise.cu", d / "spike.cu"),
                                 d / "spike_ops.cpp")


def _op_library(tmp_path):
    """The op library over copies of its files in ``tmp_path``."""
    for src in OP_LIBRARY_FILES:
        shutil.copy(spike.CSRC / src, tmp_path / src)
    return _op_library_at(tmp_path)


def test_op_library_flags(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "out"))
    flags = _op_library(tmp_path).flags()
    abi = int(torch._C._GLIBCXX_USE_CXX11_ABI)
    assert {"arch=compute_90a,code=sm_90a", "-O3", "-std=c++20", "-shared",
            f"-D_GLIBCXX_USE_CXX11_ABI={abi}", "-lc10", "-lc10_cuda",
            "-ltorch_cpu", "-ltorch_cuda"} <= set(flags)
    incs = [Path(f[2:]) for f in flags if f.startswith("-I")]
    assert any((p / "torch" / "library.h").exists() for p in incs)
    libs = [f[2:] for f in flags if f.startswith("-L")]
    assert libs and all(f"-Xlinker=-rpath={p}" in flags for p in libs)


@pytest.mark.parametrize("edit", [*OP_LIBRARY_FILES, "torch", "abi"])
def test_op_library_name_hashes_what_the_build_reads(monkeypatch, tmp_path,
                                                     edit):
    monkeypatch.setenv("REPRO_TORCH_BUILD", str(tmp_path / "out"))
    before = _op_library(tmp_path).path()
    assert before.parent == tmp_path / "out"
    assert re.fullmatch(r"libspike_ops-[0-9a-f]{12}\.so", before.name)
    if edit == "torch":
        monkeypatch.setattr(torch, "__version__", "0.0.0+other")
    elif edit == "abi":
        monkeypatch.setattr(torch._C, "_GLIBCXX_USE_CXX11_ABI",
                            not torch._C._GLIBCXX_USE_CXX11_ABI)
    else:
        with open(tmp_path / edit, "a") as f:
            f.write("\n// edited\n")
    after = _op_library_at(tmp_path).path()
    assert after != before


def _includes(name):
    text = (spike.CSRC / name).read_text()
    return set(re.findall(r'^#include [<"]([^>"]+)[>"]', text, re.M))


def test_sources_include_no_python_and_no_extension_header():
    """The binding takes torch's core headers, ATen's dispatcher-free CUDA
    allocation and c10's CUDA headers only (no ``torch/extension.h``,
    nothing of Python); the kernels no torch header at all, only the
    runtime's and the repo's own ``csrc/*.cuh``."""
    assert _includes("spike_ops.cpp") == {
        "torch/library.h", "ATen/core/Tensor.h", "ATen/cuda/EmptyTensor.h",
        "c10/cuda/CUDAGuard.h", "c10/cuda/CUDAStream.h"}
    assert _includes("spike_elementwise.cu") == {"cuda_runtime.h",
                                                 "stdint.h", "grid.cuh"}
    assert _includes("spike.cu") == {"cuda_runtime.h", "stdint.h",
                                     "grid.cuh", "threefry.cuh"}
