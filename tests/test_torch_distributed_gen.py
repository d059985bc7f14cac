"""The port's mesh step (``core.distributed_gen``) against the JAX
package's ``shard_map`` step, on the CPU.

The JAX side runs in a subprocess with
``XLA_FLAGS=--xla_force_host_platform_device_count=4`` (as
``tests/test_distributed.py`` does), so the test process keeps its one
CPU device; the port's mesh of 4 is four entries naming the CPU.  Held
exactly: the int32 ids of ``device_generate`` (n = m = 8, 1024 edges per
device, the device index the top src bits), and a ``device_steps``
dataset planned on 4 devices, every ``.npy`` file and ``manifest.json``.
int64 mesh ids are held against the host ``combine_ids`` with the device
prefix (the reference composes 64-bit ids on the device only under jax
x64).
"""
import hashlib
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import distributed_gen as dg
from repro_torch.core.descend import (IdParts, combine_ids,
                                      combine_ids_device)
from repro_torch.core.structure import KroneckerFit
from repro_torch.datastream import DatasetJob, Manifest

ROOT = Path(__file__).resolve().parents[1]
THETA = dict(a=0.45, b=0.22, c=0.2, d=0.13)
#: a device_steps dataset: 5 steps of 3 000 edges, the last ragged
STEP_FIT = dict(THETA, n=10, m=9, E=14_000)
STEP_KW = dict(shard_edges=3000, seed=4, mode="device_steps")
MESH4 = ["cpu"] * 4


def _thetas(L, seed=0):
    return np.random.default_rng(seed).dirichlet(np.ones(4), L)


def _hashes(path):
    return {f: hashlib.md5(open(os.path.join(path, f), "rb").read())
            .hexdigest() for f in sorted(os.listdir(path))
            if f.endswith(".npy") or f == "manifest.json"}


@pytest.fixture(scope="module")
def jax_mesh4(tmp_path_factory):
    """The JAX package on a 4-device CPU mesh, in one subprocess:
    ``device_generate``'s ids and a ``device_steps`` dataset."""
    out = tmp_path_factory.mktemp("jax_mesh4")
    np.save(out / "thetas.npy", _thetas(8).astype(np.float32))
    body = f"""
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.core import distributed_gen as jdg
    from repro.core.structure import KroneckerFit
    from repro.datastream import DatasetJob
    assert len(jax.devices()) == 4
    out = {str(out)!r}
    th = jnp.asarray(np.load(os.path.join(out, "thetas.npy")))
    seeds = jdg.step_seeds(5, 2, 4)
    mesh = Mesh(np.array(jax.devices()), ("d",))
    step = jax.jit(lambda t, z: jdg.device_generate(t, z, 8, 8, 1024, mesh))
    s, d = step(th, jnp.asarray(seeds))
    np.save(os.path.join(out, "src.npy"), np.asarray(s))
    np.save(os.path.join(out, "dst.npy"), np.asarray(d))
    DatasetJob(KroneckerFit(**{STEP_FIT!r}), os.path.join(out, "ds"),
               **{STEP_KW!r}).run()
    """
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", textwrap.dedent(body)],
                       capture_output=True, text=True, env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    return out


def test_mesh_of_four_matches_reference(jax_mesh4):
    th = np.load(jax_mesh4 / "thetas.npy")
    seeds = dg.step_seeds(5, 2, 4)
    s, d = dg.device_generate(th, seeds, 8, 8, 1024, mesh=MESH4)
    assert s.shape == d.shape == (4, 1024) and s.dtype == torch.int32
    np.testing.assert_array_equal(s.numpy(), np.load(jax_mesh4 / "src.npy"))
    np.testing.assert_array_equal(d.numpy(), np.load(jax_mesh4 / "dst.npy"))
    # device i owns the src ids with prefix i above the 8 suffix levels
    assert [set((s[i] >> 8).tolist()) for i in range(4)] == \
        [{0}, {1}, {2}, {3}]
    assert int(d.max()) < 2 ** 8


def test_device_steps_dataset_on_a_mesh_of_four(jax_mesh4, tmp_path):
    out = str(tmp_path / "ds")
    job = DatasetJob(KroneckerFit(**STEP_FIT), out, device="cpu",
                     mesh=MESH4, **STEP_KW)
    job.run()
    assert job.n_dev == 4 and Manifest.load(out).n_dev == 4
    assert _hashes(out) == _hashes(str(jax_mesh4 / "ds"))
    # the default mesh on the CPU is one device: a job planned on four
    # refuses to resume there
    with pytest.raises(ValueError, match="n_dev"):
        DatasetJob(KroneckerFit(**STEP_FIT), out, device="cpu",
                   **STEP_KW).resume()


def test_mesh_of_one_keeps_the_single_device_step():
    th = _thetas(11)
    seeds = dg.step_seeds(7, 3, 1)
    s1, d1 = dg.device_generate(th, seeds, 11, 9, 3000, device="cpu")
    s2, d2 = dg.device_generate(th, seeds, 11, 9, 3000, mesh=["cpu"])
    from repro_torch import random as trandom
    from repro_torch.core.sampler import get_backend
    sp, dp = get_backend("reference").sample_parts(
        trandom.fold_in(trandom.PRNGKey(0), int(seeds[0])), th, 11, 9, 3000,
        torch.device("cpu"))
    for got in (s1, s2):
        np.testing.assert_array_equal(got[0].numpy(), sp.lo.numpy())
    for got in (d1, d2):
        np.testing.assert_array_equal(got[0].numpy(), dp.lo.numpy())
    assert dg.device_mesh("cpu") == [torch.device("cpu")]


def test_int64_mesh_ids_match_host_combine():
    """n = 33 suffix levels under a 2-bit device prefix: 35-bit src ids,
    each row the host ``combine_ids`` of its words with prefix i."""
    from repro_torch import random as trandom
    from repro_torch.core.sampler import get_backend
    th = _thetas(33, seed=1)
    seeds = dg.step_seeds(1, 0, 4)
    s, d = dg.device_generate(th, seeds, 33, 32, 512, mesh=MESH4,
                              dtype=torch.int64)
    assert s.dtype == torch.int64
    for i in range(4):
        sp, dp = get_backend("reference").sample_parts(
            trandom.fold_in(trandom.PRNGKey(0), int(seeds[i])), th, 33, 32,
            512, torch.device("cpu"))
        np.testing.assert_array_equal(
            s[i].numpy(), combine_ids(sp, 33, torch.int64, prefix=i).numpy())
        np.testing.assert_array_equal(
            d[i].numpy(), combine_ids(dp, 32, torch.int64).numpy())
    assert int((s >> 33).max()) == 3 and int(s.max()) >= 2 ** 33
    with pytest.raises(ValueError, match="int64"):
        dg.device_generate(th, seeds, 30, 30, 8, mesh=MESH4)


def test_combine_ids_device_matches_reference():
    import jax.numpy as jnp

    from repro.core.descend import IdParts as JIdParts
    from repro.core.descend import combine_ids_device as jcombine
    rng = np.random.default_rng(2)
    hi = rng.integers(0, 2 ** 5, 100).astype(np.int32)
    lo = rng.integers(0, 2 ** 31, 100).astype(np.int32)
    got = combine_ids_device(IdParts(None, torch.from_numpy(lo % 2 ** 20)),
                             20, torch.int32, prefix=torch.tensor(3))
    want = jcombine(JIdParts(None, jnp.asarray(lo % 2 ** 20)), 20, np.int32,
                    prefix=jnp.asarray(3, jnp.int32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    wide = combine_ids_device(IdParts(torch.from_numpy(hi),
                                      torch.from_numpy(lo)), 36,
                              torch.int64, prefix=torch.tensor(2))
    np.testing.assert_array_equal(
        wide.numpy(), (np.int64(2) << 36) + (hi.astype(np.int64) << 31) + lo)


@pytest.mark.parametrize("n_dev", [0, 3, 6])
def test_mesh_size_must_be_a_power_of_two(n_dev):
    with pytest.raises(ValueError, match="power of two"):
        dg.device_generate(_thetas(8), np.zeros(n_dev, np.int32), 8, 8, 16,
                           mesh=["cpu"] * n_dev)
