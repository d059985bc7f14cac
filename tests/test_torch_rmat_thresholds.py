"""The in-register R-MAT kernel's integer arithmetic, on the CPU.

The CUDA kernel ``rmat_prng`` (``csrc/rmat_sample.cu``) compares each
level's 23-bit mantissa ``k = b >> 9`` with integer thresholds made from
the float32 θ sums, where the plain versions compare the uniform
``bits_to_unit(b)`` with the sums themselves.  ``kernels/ref.py`` holds the
kernel's mirror: ``unit_threshold`` and ``rmat_prng_thresholds_ref``.
Here the threshold rule is held to the float compare over all 2^23
mantissas, and the integer descend to ``rmat_prng_ref`` (and, at one
shape, to the JAX package's ``pallas_bits`` stream).  Ids are integers:
they must match exactly."""
import jax
import numpy as np
import pytest
import torch

from repro.core import sampler as jsampler
from repro_torch import random as tr
from repro_torch.core.descend import combine_ids
from repro_torch.kernels import ref

TH = [0.45, 0.22, 0.2, 0.13]
STEP = 2.0 ** -23


def _f32(x):
    return np.float32(x)


def _grid_edges():
    """Thresholds on the 2^-23 grid and one float32 step either side."""
    out = []
    for j in (1, 2, 3, 1 << 10, (1 << 22) + 1, (1 << 23) - 1):
        t = _f32(j * STEP)
        out += [t, np.nextafter(t, _f32(0)), np.nextafter(t, _f32(2))]
    return out


def _row_sums(rows):
    """a, a+b, (a+b)+c and a+c of float32 θ rows, summed in float32 as
    the kernel and the reference sum them."""
    th = torch.tensor(np.asarray(rows, np.float32))
    a, b, c = th[:, 0], th[:, 1], th[:, 2]
    ab = a + b
    return torch.cat([a, ab, ab + c, a + c]).tolist()


THRESHOLDS = {
    "special": [0.0, -0.0, 1.0, 1.5, 2.0, -0.25, STEP, 1 - STEP / 2,
                1 - STEP, float(np.nextafter(_f32(1), _f32(0))), 1e-45,
                float("inf"), float("-inf")],
    "grid": [float(t) for t in _grid_edges()],
    "demo_rows": _row_sums([TH, [0.5, 0.2, 0.2, 0.1], [0.0, 0.0, 1.0, 0.0],
                            [1.0, 0.0, 0.0, 0.0], [0.7, 0.6, 0.3, 0.0]]),
    "noisy_rows": _row_sums(np.random.default_rng(11).dirichlet(
        np.ones(4), size=8).astype(np.float32)),
}


@pytest.fixture(scope="module")
def mantissas():
    """Every 23-bit mantissa as a word with random low 9 bits, and its
    uniform by the plain versions' mantissa trick."""
    k = torch.arange(ref.UNIT_STEPS, dtype=torch.int64)
    low = torch.from_numpy(np.random.default_rng(0).integers(
        0, 512, ref.UNIT_STEPS))
    words = tr._to_int32((k << 9) | low)
    return k, ref.bits_to_uniform_ref(words)


@pytest.mark.parametrize("group", sorted(THRESHOLDS))
def test_unit_threshold_is_the_float_compare(mantissas, group):
    """``(b >> 9) >= unit_threshold(t)`` equals ``bits_to_unit(b) >= t``
    for every mantissa and every threshold of the group."""
    k, u = mantissas
    ts = torch.tensor(THRESHOLDS[group], dtype=torch.float32)
    T = ref.unit_threshold(ts)
    assert int(T.min()) >= 0 and int(T.max()) <= ref.UNIT_STEPS
    for t, Ti in zip(ts, T.tolist()):
        assert torch.equal(k >= Ti, u >= t), (group, float(t), Ti)


def test_unit_threshold_of_nan_is_never():
    assert ref.unit_threshold(torch.tensor([float("nan")])).item() \
        == ref.UNIT_STEPS


def _thetas(L, th=TH):
    return torch.from_numpy(np.tile(np.asarray(th, np.float32), (L, 1)))


def _same(got, want):
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert (x is None) == (y is None)
            if x is not None:
                assert torch.equal(x, y)


@pytest.mark.parametrize("n,m,E,stride", [
    (12, 9, 3000, 3072),              # test_torch_kernels' narrow shape
    (34, 30, 1000, 1024),             # wide ids, both sides
    (9, 34, 777, 800),                # wide dst, narrow src
    (6, 14, 1001, 1001),              # n < m: the tail feeds dst
    (15, 4, 1003, 1100),              # n > m: the tail feeds src
    (0, 12, 513, 513),                # every level one-sided
    (10, 0, 514, 600),
    (27, 27, 1000, 1 << 28),          # L * stride > 2^32
    (20, 33, 999, 1 << 29),           # ... with wide ids
])
def test_integer_descend_is_the_plain_version(n, m, E, stride):
    L = max(n, m)
    key = tr.fold_in(tr.PRNGKey(n * 64 + m), 3)
    th = torch.from_numpy(np.random.default_rng(L).dirichlet(
        np.ones(4), size=L).astype(np.float32))
    _same(ref.rmat_prng_thresholds_ref(key, th, n, m, E, stride),
          ref.rmat_prng_ref(key, th, n, m, E, stride))


@pytest.mark.parametrize("rows", [
    [[0.0, 0.0, 1.0, 0.0]],
    [[1.0, 0.0, 0.0, 0.0]],
    [[0.5, 0.5, 0.0, 0.0]],
    [[0.7, 0.6, 0.3, 0.0]],                   # sums above 1
    [[3 * STEP, STEP, (1 << 22) * STEP, 0.5]],  # on the 2^-23 grid
    [[float(np.nextafter(_f32(0.25), _f32(0))), 0.25, 0.25, 0.25]],
    [[-0.25, 0.5, 0.5, 0.25]],               # a negative entry
])
def test_integer_descend_at_threshold_edges(rows):
    """θ rows whose sums lie on or just off the 2^-23 grid, at 0, 1 or
    beyond, broadcast to every level, narrow and wide."""
    for n, m in ((11, 7), (7, 11), (33, 32)):
        th = _thetas(max(n, m), rows[0])
        key = tr.PRNGKey(5)
        _same(ref.rmat_prng_thresholds_ref(key, th, n, m, 2049, 2051),
              ref.rmat_prng_ref(key, th, n, m, 2049, 2051))


@pytest.mark.parametrize("n,m,nudge", [(10, 7, 0), (10, 7, -1), (10, 7, 1),
                                       (7, 10, 0), (33, 31, 0)])
def test_integer_descend_with_words_on_the_thresholds(n, m, nudge):
    """Per-level θ built from the words the levels draw: a, a+b and
    (a+b)+c are three edges' own uniforms (sorted), moved ``nudge``
    float32 steps, so those edges sit on (or one step beside) every
    threshold they meet."""
    L, E, stride = max(n, m), 1500, 1600
    key = tr.PRNGKey(77)
    cols = torch.arange(E, dtype=torch.int64)
    rng = np.random.default_rng(n + 3 * m)
    rows, targets = [], []
    for ell in range(L):
        u = ref.bits_to_uniform_ref(tr.bits_at(key, cols + ell * stride))
        t = np.sort(u[rng.choice(E, 3, replace=False)].numpy())
        for _ in range(abs(nudge)):
            t = np.nextafter(t, np.float32(np.sign(nudge) * 2))
        rows.append([t[0], t[1] - t[0], t[2] - t[1], 0.0])
        targets.append(t)
    th = torch.tensor(np.asarray(rows, np.float32))
    if nudge == 0:      # on the grid, the float32 sums are the uniforms
        ab = th[:, 0] + th[:, 1]
        assert torch.equal(torch.stack([th[:, 0], ab, ab + th[:, 2]], 1),
                           torch.tensor(np.asarray(targets)))
    _same(ref.rmat_prng_thresholds_ref(key, th, n, m, E, stride),
          ref.rmat_prng_ref(key, th, n, m, E, stride))


def test_integer_descend_is_the_pallas_bits_stream():
    if not jax.config.jax_threefry_partitionable:
        pytest.skip("jax is set to the non-partitionable threefry mode")
    n, m, E = 12, 9, 3000
    th = _thetas(max(n, m))
    s1, d1 = jsampler.get_backend("pallas_bits").sample(
        jax.random.PRNGKey(9), th.numpy(), n, m, E, id_dtype=np.int32)
    pad = jsampler._pad_edges(E, jsampler.choose_block(E))
    src, dst = ref.rmat_prng_thresholds_ref(tr.PRNGKey(9), th, n, m, E, pad)
    np.testing.assert_array_equal(combine_ids(src, n, np.int32).numpy(),
                                  np.asarray(s1))
    np.testing.assert_array_equal(combine_ids(dst, m, np.int32).numpy(),
                                  np.asarray(d1))
