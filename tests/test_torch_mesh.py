"""The port on a mesh of four ``gloo`` ranks on the CPU, against its own
unsharded step and the JAX package on four host devices.

One spawn of four ranks (``tests/_torch_mesh_workers.py``) runs every
job; each test holds one job's results:

* a tensor dim over two axes (``("pod", "data")``) is split major to
  minor as a ``PartitionSpec`` splits it, checked on shard contents;
* the elastic restore: saved ``("data", "model")`` on 2 × 2, restored
  ``("model", "data")`` on 4 × 1 (the reference's
  ``test_elastic_restore_different_mesh``);
* ``compressed_psum`` over 4 ranks with different gradients equals the
  reference's over 4 host devices to 1e-6 (the mean-scale quirk shows);
* qwen3-moe's ``moe_path="ep"`` loss equals the reference's ``ep`` loss
  on a 2 × 2 host-device mesh to 1e-5;
* two train steps of tinyllama and qwen3-moe (and of zamba2, rwkv6 and
  seamless, whose scans, conv, channel mix and cross attention run in
  ``local_map`` too) at smoke width in float32 on a 2 × 2 mesh: losses
  and masters equal the port's unsharded step to 1e-5 relative, and
  each leaf's local shard shape the reference's
  ``NamedSharding.shard_shape``.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

sys.path.insert(0, os.path.dirname(__file__))
import _torch_mesh_workers as W  # noqa: E402

from repro.distributed.compression import compress_tree as r_compress  # noqa
from repro_torch import random as trandom  # noqa: E402
from repro_torch.models import Model  # noqa: E402
from repro_torch.models.params import leaves  # noqa: E402
from repro_torch.training import optimizer as opt  # noqa: E402
from repro_torch.training import steps  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("mesh"))
    W.run_ranks("all", out)
    return out


def _jax_reference(body: str, devices: int = 4) -> dict:
    """Run ``body`` under ``devices`` host devices; its last stdout line
    is a JSON object."""
    script = ("import os\n"
              "os.environ['XLA_FLAGS']='--xla_force_host_platform_device_"
              f"count={devices}'\n" + textwrap.dedent(body))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", script], capture_output=True,
                       text=True, env=env, cwd=ROOT, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    return json.loads(r.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def reference():
    grads = [{k: v.tolist() for k, v in W.rank_grads(r).items()}
             for r in range(W.WORLD)]
    b = W.batches(W.smoke_cfg("qwen3-moe-30b-a3b"), 1)[0]
    return _jax_reference(f"""
    import json
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs import get_config
    from repro.distributed.compression import (compressed_psum,
                                               init_error_buffer)
    from repro.models.model import Model
    from repro.utils import make_mesh_compat
    # compressed_psum: each device its own gradients, claimed replicated
    mesh = make_mesh_compat((4,), ("pod",))
    devs = list(mesh.devices.flat)
    grads = {grads!r}
    g = {{k: jax.make_array_from_single_device_arrays(
        np.asarray(grads[0][k]).shape, NamedSharding(mesh, P()),
        [jax.device_put(np.asarray(grads[i][k], np.float32), d)
         for i, d in enumerate(devs)]) for k in grads[0]}}
    e = init_error_buffer(g)
    with mesh:
        out, e2 = compressed_psum(g, e, mesh, axis="pod")
    comp = {{k: np.asarray(v.addressable_shards[0].data).tolist()
            for k, v in out.items()}}
    # the ep loss on a 2 x 2 mesh
    cfg = get_config("qwen3-moe-30b-a3b").smoke().replace(
        dtype="float32", moe_path="ep")
    m = Model(cfg)
    params = m.init_params(jax.random.PRNGKey(0))
    batch = {{"tokens": jnp.asarray({b["tokens"].tolist()!r}, jnp.int32),
              "labels": jnp.asarray({b["labels"].tolist()!r}, jnp.int32)}}
    mesh2 = make_mesh_compat((2, 2), ("data", "model"))
    with mesh2:
        ep = float(m.loss(params, batch, mesh=mesh2))
    tp = float(m.loss(params, batch))
    print(json.dumps({{"compressed": comp, "ep": ep, "tp": tp}}))
    """)


def test_dim_over_two_axes_splits_major_to_minor(ranks):
    x = np.arange(24, dtype=np.float32).reshape(8, 3)
    for r in range(W.WORLD):
        got = json.load(open(os.path.join(ranks, f"contents.{r}.json")))
        # device (pod i, data j) holds block i·2 + j, as jax lays it out
        np.testing.assert_array_equal(got["a"], x[2 * r:2 * r + 2])
        # ("model", "data") on (data, model): dim 0 over model, 1 over data
        i, j = divmod(r, 2)
        np.testing.assert_array_equal(got["b"], x[:4, :2][2 * j:2 * j + 2,
                                                          i:i + 1])


def test_elastic_restore_onto_another_mesh(ranks):
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    for r in range(W.WORLD):
        got = json.load(open(os.path.join(ranks, f"elastic.{r}.json")))
        assert got["step"] == 1
        np.testing.assert_array_equal(got["full"], x)
        # mesh (data 4, model 1): dim 1 over data; dim 0 over model, whose
        # one rank holds it whole (a shard of one is laid out replicated)
        assert got["placements"] == ["Shard(dim=1)", "Replicate()"]
        d = got["coord"][0]
        np.testing.assert_array_equal(got["local"], x[:, 2 * d:2 * d + 2])


def test_compressed_psum_equals_the_reference(ranks, reference):
    want = reference["compressed"]
    grads = [W.rank_grads(r) for r in range(W.WORLD)]
    for r in range(W.WORLD):
        got = np.load(os.path.join(ranks, f"compressed.{r}.npz"))
        for k in want:
            np.testing.assert_allclose(got[f"out_{k}"], want[k], rtol=1e-6,
                                       atol=1e-7)
        # each rank's own residual, as the reference's compress_tree
        import jax.numpy as jnp
        _, _, e = r_compress({k: jnp.asarray(v) for k, v in
                              grads[r].items()},
                             {k: jnp.zeros(v.shape, jnp.float32)
                              for k, v in grads[r].items()})
        for k in e:
            np.testing.assert_array_equal(got[f"err_{k}"], np.asarray(e[k]))
    # the mean-scale quirk: not the mean of each rank's dequantized value
    mean = np.mean([g["a"] for g in grads], axis=0)
    assert np.abs(np.asarray(want["a"]) - mean).max() > 1e-3


def test_ep_loss_equals_the_reference_ep(ranks, reference):
    got = json.load(open(os.path.join(ranks, "ep.json")))["loss"]
    assert abs(got - reference["ep"]) <= 1e-5 * abs(reference["ep"])


@pytest.fixture(scope="module")
def unsharded():
    res = {}
    for arch in W.STEP_ARCHS:
        cfg = W.smoke_cfg(arch, microbatches=2)
        model = Model(cfg, "cpu")
        params = model.init_params(trandom.PRNGKey(0))
        state = opt.init_opt_state(params)
        step = steps.make_train_step(model, opt.OptConfig(**W.HP))
        losses, lrs, g1 = [], [], None
        for b in W.batches(cfg):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
            lrs.append(float(m["lr"]))
            if g1 is None:      # the first moment after step 1: 0.1·g₁
                g1 = [t.numpy() / (1 - opt.OptConfig().beta1)
                      for t in leaves(state.mu)]
        res[arch] = {"losses": losses, "lrs": lrs, "g1": g1,
                     "masters": [t.numpy() for t in leaves(state.master)]}
    return res


@pytest.mark.parametrize("arch", W.STEP_ARCHS)
def test_sharded_step_equals_the_unsharded_step(arch, ranks, unsharded):
    got = np.load(os.path.join(ranks, "sharded_step.npy"),
                  allow_pickle=True).item()[arch]
    want = unsharded[arch]
    # the hybrid's float32 gradients are ill-conditioned (its training is
    # chaotic in both packages, tests/test_torch_families_trainer_
    # recurrent.py): the entries Adam's first update is unsure of move its
    # second gradient, its second loss by ~2e-5, and its masters only
    # within the bound below
    chaotic = arch == "zamba2-1.2b"
    np.testing.assert_allclose(got["losses"][:1], want["losses"][:1],
                               rtol=1e-5)
    np.testing.assert_allclose(got["losses"], want["losses"],
                               rtol=1e-4 if chaotic else 1e-5)
    # Adam's first update lr·g/(|g| + 1e-8) turns last-bit differences of
    # a gradient near 1e-8 into a part of lr: masters are held to 1e-5
    # where the first gradient is large enough for the update to be sure
    # of it (or zero: a row no token reached), and to 2·(lr₁ + lr₂)
    # elsewhere (as chip_smoke.py's phase 20)
    bound = 2 * sum(want["lrs"])
    n_sure = n = 0
    for g, w, g1 in zip(got["masters"], want["masters"], want["g1"]):
        sure = (np.abs(g1) > 1e-6) | (g1 == 0)
        if not chaotic:
            np.testing.assert_allclose(g[sure], w[sure], rtol=1e-5,
                                       atol=1e-6)
        assert np.abs(g - w).max() <= bound
        n_sure, n = n_sure + int(sure.sum()), n + sure.size
    assert n_sure > 0.9 * n, (n_sure, n)


@pytest.mark.parametrize("arch", W.STEP_ARCHS)
def test_local_shard_shapes_are_the_reference(arch, ranks):
    from repro.configs import get_config as r_get_config
    from repro.distributed import sharding as rshd
    from repro.models.model import Model as RModel
    from repro.training import optimizer as ropt
    from repro.training import steps as rsteps
    got = np.load(os.path.join(ranks, "sharded_step.npy"),
                  allow_pickle=True).item()[arch]
    mesh = AbstractMesh((2, 2), ("data", "model"))
    rcfg = r_get_config(arch).smoke().replace(dtype="float32",
                                              microbatches=2)
    rm = RModel(rcfg)
    rules = rshd.make_rules(rcfg, mesh)
    shapes = [tuple(x.shape) for x in jax.tree.leaves(rm.abstract_params())]
    p_sh = jax.tree.leaves(rshd.tree_shardings(
        rm.param_dims(), rm.abstract_params(), rules, mesh))
    mu_sh = jax.tree.leaves(rsteps.opt_state_shardings(
        ropt.abstract_opt_state(rm.abstract_params()), rm.param_dims(),
        rules, mesh).mu)
    assert [tuple(s) for s in got["param_shapes"]] == \
        [sh.shard_shape(s) for sh, s in zip(p_sh, shapes)]
    assert [tuple(s) for s in got["mu_shapes"]] == \
        [sh.shard_shape(s) for sh, s in zip(mu_sh, shapes)]
    assert any(a != b for a, b in zip(got["param_shapes"], shapes))
