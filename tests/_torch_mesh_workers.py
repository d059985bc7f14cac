"""Worker processes of the port's multi-rank CPU tests: four ``gloo``
ranks on ``localhost`` (``run_ranks``), each running one of the jobs
below and rank 0 writing what it found to an ``.npz``/``.json`` for the
test to hold against the JAX package and the unsharded port."""
import json
import os
import socket
import traceback

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

WORLD = 4


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _entry(rank, port, job, out_dir):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=WORLD)
    try:
        JOBS[job](rank, out_dir)
    except BaseException:
        with open(os.path.join(out_dir, f"error.{job}.{rank}"), "w") as f:
            f.write(traceback.format_exc())
        raise
    finally:
        dist.destroy_process_group()


def run_ranks(job: str, out_dir: str) -> None:
    """``job`` on four gloo ranks; raises with the first rank's
    traceback if one failed."""
    try:
        mp.start_processes(_entry, args=(free_port(), job, out_dir),
                           nprocs=WORLD, start_method="spawn")
    except Exception:
        errs = sorted(f for f in os.listdir(out_dir)
                      if f.startswith("error."))
        if errs:
            raise RuntimeError(open(os.path.join(out_dir, errs[0])).read())
        raise


# ---------------------------------------------------------------------------
# jobs
# ---------------------------------------------------------------------------

def smoke_cfg(arch: str, **kw):
    from repro_torch.configs import get_config
    return get_config(arch).smoke().replace(dtype="float32", **kw)


def batches(cfg, n: int = 2, B: int = 8, S: int = 32, seed: int = 0):
    """``n`` seeded batches of S positions (the encdec: S/2 frames and
    S/2 tokens)."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        T = S // 2 if cfg.family == "encdec" else S
        b = {"tokens": r.integers(0, cfg.vocab, (B, T)).astype(np.int32),
             "labels": r.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
        if cfg.family == "encdec":
            b["frames"] = r.normal(0, 1, (B, S - T, cfg.d_model)).astype(
                np.float32)
        out.append(b)
    return out


HP = dict(lr=1e-3, warmup_steps=2, total_steps=20)
STEP_ARCHS = ("tinyllama-1.1b", "qwen3-moe-30b-a3b", "zamba2-1.2b",
              "rwkv6-7b", "seamless-m4t-medium")


def _sharded_step(rank, out_dir):
    """Two train steps of each smoke config on a 2 × 2 mesh: losses,
    gathered masters and each leaf's local shard shapes."""
    from repro_torch import random as trandom
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    from repro_torch.models.params import leaves
    from repro_torch.training import optimizer as opt
    from repro_torch.training import steps
    mesh = make_local_mesh(2, 2, device_type="cpu")
    res = {}
    for arch in STEP_ARCHS:
        cfg = smoke_cfg(arch, microbatches=2)
        model = Model(cfg, "cpu")
        rules = shd.make_rules(cfg, mesh)
        params = model.init_params(trandom.PRNGKey(0))
        o_sh = steps.opt_state_shardings(
            opt.abstract_opt_state(model.abstract_params()),
            model.param_dims(), rules, mesh)
        p_sh = shd.tree_shardings(model.param_dims(),
                                  model.abstract_params(), rules, mesh)
        state = steps.place(opt.init_opt_state(params), o_sh)
        params = steps.place(params, p_sh)
        step = steps.make_train_step(model, opt.OptConfig(**HP), mesh)
        losses = []
        for b in batches(cfg):
            params, state, m = step(params, state, b)
            losses.append(float(m["loss"]))
        res[arch] = {
            "losses": losses,
            "masters": [t.full_tensor().numpy() for t in
                        leaves(state.master)],
            "param_shapes": [list(t.to_local().shape)
                             for t in leaves(params.tree())],
            "mu_shapes": [list(t.to_local().shape)
                          for t in leaves(state.mu)]}
    if rank == 0:
        np.save(os.path.join(out_dir, "sharded_step.npy"), res,
                allow_pickle=True)


def _ep_loss(rank, out_dir):
    """qwen3-moe's smoke loss with ``moe_path="ep"`` on a 2 × 2 mesh."""
    from repro_torch import random as trandom
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import Model
    mesh = make_local_mesh(2, 2, device_type="cpu")
    cfg = smoke_cfg("qwen3-moe-30b-a3b", moe_path="ep")
    model = Model(cfg, "cpu")
    params = model.init_params(trandom.PRNGKey(0))
    from repro_torch.training import steps
    rules = shd.make_rules(cfg, mesh)
    params = steps.place(params, shd.tree_shardings(
        model.param_dims(), model.abstract_params(), rules, mesh))
    b = batches(cfg, 1)[0]
    bsh = steps.batch_shardings(b, mesh, rules)
    batch = {k: shd.distribute(torch.from_numpy(v), bsh[k])
             for k, v in b.items()}
    with torch.no_grad():
        loss = model.loss(params, batch, mesh=mesh).full_tensor()
    if rank == 0:
        with open(os.path.join(out_dir, "ep.json"), "w") as f:
            json.dump({"loss": float(loss)}, f)


def _elastic(rank, out_dir):
    """Save an (8, 8) leaf laid out ("data", "model") on a 2 × 2 mesh,
    restore it ("model", "data") on 4 × 1."""
    from repro_torch.distributed import checkpoint as ck
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_local_mesh
    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    mesh1 = make_local_mesh(2, 2, device_type="cpu")
    xs = shd.distribute(x, shd.NamedSharding(mesh1, ("data", "model")))
    d = os.path.join(out_dir, "ckpt")
    ck.save(d, 1, {"w": xs})
    mesh2 = make_local_mesh(4, 1, device_type="cpu")
    sh2 = {"w": shd.NamedSharding(mesh2, ("model", "data"))}
    got, step = ck.restore(d, {"w": x}, shardings=sh2)
    w = got["w"]
    res = {"step": step, "full": w.full_tensor().tolist(),
           "placements": [repr(p) for p in w.placements],
           "local": w.to_local().tolist(),
           "coord": mesh2.get_coordinate()}
    with open(os.path.join(out_dir, f"elastic.{rank}.json"), "w") as f:
        json.dump(res, f)


def _contents(rank, out_dir):
    """Shard contents of a dim over two axes, ("pod", "data"), and of
    two dims over (data, model)."""
    from repro_torch.distributed import sharding as shd
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                      mesh_dim_names=("pod", "data"))
    x = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    a = shd.distribute(x, shd.NamedSharding(mesh, (("pod", "data"),)))
    mesh2 = DeviceMesh("cpu", torch.arange(4).reshape(2, 2),
                       mesh_dim_names=("data", "model"))
    b = shd.distribute(x[:4, :2].contiguous(),
                       shd.NamedSharding(mesh2, ("model", "data")))
    with open(os.path.join(out_dir, f"contents.{rank}.json"), "w") as f:
        json.dump({"a": a.to_local().tolist(), "b": b.to_local().tolist()},
                  f)


def _compressed(rank, out_dir):
    """``compressed_psum`` over a 4-rank ``pod`` axis, each rank its own
    gradients (numpy seed = rank)."""
    from repro_torch.distributed.compression import (compressed_psum,
                                                     init_error_buffer)
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh("cpu", torch.arange(4), mesh_dim_names=("pod",))
    g = {k: torch.from_numpy(v) for k, v in rank_grads(rank).items()}
    out, err = compressed_psum(g, init_error_buffer(g), mesh, axis="pod")
    np.savez(os.path.join(out_dir, f"compressed.{rank}.npz"),
             **{f"out_{k}": v.numpy() for k, v in out.items()},
             **{f"err_{k}": v.numpy() for k, v in err.items()})


def rank_grads(rank: int) -> dict:
    r = np.random.default_rng(rank)
    return {"a": r.normal(0, 1 + rank, (16, 8)).astype(np.float32),
            "b": r.normal(0, 0.1, (5,)).astype(np.float32)}


JOBS = {"sharded_step": _sharded_step, "ep": _ep_loss,
        "elastic": _elastic, "contents": _contents,
        "compressed": _compressed}


def _all(rank, out_dir):
    for name in ("contents", "elastic", "compressed", "ep", "sharded_step"):
        JOBS[name](rank, out_dir)


JOBS["all"] = _all
