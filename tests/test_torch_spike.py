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
"""
import runpy
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from repro_torch.kernels import spike

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
