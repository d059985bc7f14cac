"""The port's structure tables (``repro_torch.benchmarks``: Table 3,
Table 8, Table 10, Fig. 2, Fig. 8) against the JAX package's
``benchmarks/`` modules, on the CPU.

Each test runs both in a temporary working directory.  The port's
``run(fast=True, device="cpu")`` must give the JAX module's row names
(apart from the renames its docstring lists) and, where the path is
exact, the same derived fields: Table 3's and Table 8's edge counts,
Fig. 2's maximum degree and effective diameter and its curves, Table 10's
statistics.  Where a JAX field does not depend on a draw (Table 3 and 8
print the edge count they asked for), the JAX module's draw is replaced
by zeros of that size, which keeps its compiles out of the test; its
row loop and its fields are its own.
"""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.benchmarks import (fig2_distributions, fig8_throughput,
                                    table3_scaling, table8_er_timings,
                                    table10_structural_stats)
from repro_torch.core import sampler

ROOT = Path(__file__).resolve().parents[1]

#: torch's intra-op threads in these tests
TORCH_THREADS = 2


@pytest.fixture(autouse=True)
def few_torch_threads():
    """``TORCH_THREADS`` intra-op threads for the port: the suite runs in
    several worker processes at once, and a full torch thread pool in
    each would oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, TORCH_THREADS))
    yield
    torch.set_num_threads(n)


@pytest.fixture
def jax_table(tmp_path, monkeypatch):
    """Load ``benchmarks/<name>.py`` by path, with the working directory
    a temporary one (both packages write their results under it)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.syspath_prepend(str(ROOT))

    def load(name):
        spec = importlib.util.spec_from_file_location(
            f"jax_benchmarks_{name}", ROOT / "benchmarks" / f"{name}.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod
    return load


def _fields(derived: str) -> dict:
    return dict(kv.split("=", 1) for kv in derived.split(";"))


def _names(rows):
    return [r["name"] for r in rows]


def _no_tpu_numbers(rows):
    for r in rows:
        text = f"{r['name']} {r['derived']}".lower()
        assert "v5e" not in text and "tpu" not in text and "pod" not in text


def test_table3_rows_and_edge_counts(jax_table, tmp_path, monkeypatch):
    jmod = jax_table("table3_scaling")
    monkeypatch.setattr(jmod, "sample_graph_chunked",
                        lambda key, fit, k_pref: (jnp.zeros(fit.E, jnp.int32),
                                                  jnp.zeros(fit.E, jnp.int32)))
    want = jmod.run(fast=True)
    got = table3_scaling.run(fast=True, device="cpu")
    assert _names(got) == _names(want) == [
        "table3/scale1x", "table3/scale2x", "table3/scale4x"]
    for g, w in zip(got, want):
        assert _fields(g["derived"])["edges"] == _fields(w["derived"])["edges"]
        assert g["us_per_call"] > 0
    _no_tpu_numbers(got)
    on_disk = json.loads((tmp_path / "results" / "bench_torch"
                          / "table3_scaling.json").read_text())
    assert _names(on_disk) == _names(got)


def test_table8_rows_and_edge_counts(jax_table, monkeypatch):
    jmod = jax_table("table8_er_timings")
    monkeypatch.setattr(jmod, "sample_erdos_renyi",
                        lambda key, a, b, e: (jnp.zeros(e, jnp.int32),
                                              jnp.zeros(e, jnp.int32)))
    want = jmod.run(fast=True)
    got = table8_er_timings.run(fast=True, device="cpu")
    assert _names(got) == _names(want)
    for g, w in zip(got, want):
        assert _fields(g["derived"])["edges"] == _fields(w["derived"])["edges"]


def test_table10_statistics_equal(jax_table):
    """On the CPU the port's auto backend is the ``reference`` stream, the
    JAX package's ``xla``: the sampled graphs and every statistic are the
    JAX module's."""
    want = jax_table("table10_structural_stats").run(fast=True)
    got = table10_structural_stats.run(fast=True, device="cpu")
    assert _names(got) == _names(want) == [
        "table10/original", "table10/ours_no_noise", "table10/ours_noise",
        "table10/rmat_default"]
    assert [r["derived"] for r in got] == [r["derived"] for r in want]


def test_fig2_curves_equal(jax_table, tmp_path):
    want = jax_table("fig2_distributions").run(fast=True)
    want_curves = json.loads((tmp_path / "results" / "bench"
                              / "fig2_curves.json").read_text())
    got = fig2_distributions.run(fast=True, device="cpu")
    got_curves = json.loads((tmp_path / "results" / "bench_torch"
                             / "fig2_curves.json").read_text())
    assert _names(got) == _names(want)
    assert [r["derived"] for r in got] == [r["derived"] for r in want]
    assert got_curves.keys() == want_curves.keys()
    for k in want_curves:
        assert got_curves[k]["degree_hist"] == want_curves[k]["degree_hist"]
        np.testing.assert_allclose(got_curves[k]["hop_plot"],
                                   want_curves[k]["hop_plot"], rtol=1e-12)


#: fig8's renames (the module's docstring lists them)
FIG8_RENAMES = {"fig8/xla": "fig8/reference",
                "fig8/pallas_bits": "fig8/cuda_bits",
                "fig8/pallas_prng": "fig8/cuda_prng",
                "fig8/v5e_kernel_bits_roofline": "fig8/h100_kernel_bits_bound",
                "fig8/v5e_kernel_prng_roofline": "fig8/h100_kernel_prng_bound"}


def test_fig8_rows_renamed_and_gated(jax_table, monkeypatch):
    jmod = jax_table("fig8_throughput")
    monkeypatch.setattr(jmod, "_time_backend", lambda be, th, n, m, E: 1.0)
    want = jmod.run(fast=True)
    got = fig8_throughput.run(fast=True, device="cpu")
    assert _names(want)[-1] == "fig8/v5e_pod_256chips_prng"   # one card
    assert _names(got) == [FIG8_RENAMES[n] for n in _names(want)[:-1]]
    _no_tpu_numbers(got)
    # the edge counts are the JAX module's under the port's names
    assert fig8_throughput.E_FAST == {
        FIG8_RENAMES[f"fig8/{k}"][5:]: v for k, v in jmod._E_FAST.items()}
    assert fig8_throughput.E_FULL == {
        FIG8_RENAMES[f"fig8/{k}"][5:]: v for k, v in jmod._E_FULL.items()}
    rows = {r["name"]: r for r in got}
    assert rows["fig8/reference"]["us_per_call"] > 0
    assert _fields(rows["fig8/reference"]["derived"]).keys() == {"eps"}
    for name in ("cuda_bits", "cuda_prng"):
        why = sampler.get_backend(name).why_unavailable()
        derived = rows[f"fig8/{name}"]["derived"]
        assert rows[f"fig8/{name}"]["us_per_call"] == 0.0
        assert derived.startswith("not timed: unavailable: ")
        if why is not None:
            assert derived == f"not timed: unavailable: {why}"


def test_fig8_bounds_are_the_h100s():
    L = fig8_throughput.N_LEVELS
    assert fig8_throughput.bound_s("cuda_bits", 10) == pytest.approx(
        10 * (4 * L + 8) / 3.35e12, rel=1e-12)
    # K2, a level and edge: 21 xors on the alu pipe, 27 adds on either
    # pipe, 20 rotations each one alu op or two FMA-pipe ops; with 64 alu
    # and 64 FMA lanes and 128 issued an SM clock (132 SMs at 1.98 GHz) the
    # least time puts 14/3 rotations on the FMA pipe: 21 + 20 - 14/3 alu
    # ops against 27 + 28/3 FMA ops, and 68 + 14/3 issued
    ops = L * 10 * ((21 + 20 - 14 / 3) / 64) / (132 * 1.98e9)
    assert (27 + 28 / 3) / 64 == pytest.approx((21 + 20 - 14 / 3) / 64)
    assert (68 + 14 / 3) / 128 == pytest.approx((21 + 20 - 14 / 3) / 64)
    for name in ("cuda_prng", "reference"):
        assert fig8_throughput.bound_s(name, 10) == pytest.approx(ops,
                                                                  rel=1e-12)


def test_prng_floor_is_the_best_split_of_its_rotations():
    """K2's floor is the least time over every split of threefry's 20
    rotations between the alu pipe (one funnel shift) and the FMA pipe
    (two IMADs), on a grid of 1/300 rotation, and below the split that
    keeps them all on the alu pipe."""
    from repro_torch.kernels import bounds
    x, r, a = (bounds.PRNG_XORS_PER_LEVEL, bounds.PRNG_ROTATIONS_PER_LEVEL,
               bounds.PRNG_ADDS_PER_LEVEL)
    grid = [bounds.pipe_clocks(x + r - f, 2 * f, a)
            for f in np.linspace(0.0, r, 300 * r + 1)]
    floor = bounds.prng_level_clocks()
    assert floor <= min(grid) + 1e-12
    assert floor == pytest.approx(min(grid), rel=1e-12)
    assert floor < bounds.pipe_clocks(x + r, 0, a) == (x + r) / 64
    assert bounds.pipe_clocks(0, 0, 128) == 1.0
