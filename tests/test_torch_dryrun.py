"""The port's dry-run (``repro_torch.launch``) against the JAX package's:

* ``matmul_param_count`` and ``model_flops`` equal the reference's for
  every architecture and ``LM_SHAPES`` cell;
* the depth probe (L = 1, 2; the hybrid's ΔM/ΔA, encdec's ΔE/ΔD) equals
  a full-depth ``FlopCounterMode`` count of the same step to 1e-6, and
  the per-device FLOPs of a direct full-depth probe exactly;
* per-device argument bytes of the llama3-8b and qwen3-moe smoke cells on
  (2, 4) equal the reference's ``build_cell`` in-shardings'
  ``shard_shape`` bytes;
* a tensor-parallel MLP block on a (1, 4) mesh records Megatron's two
  all-reduces, with the link bytes of the reference's
  ``parse_collectives`` on the same collectives in HLO;
* the graph-generation cell has no collective and the reference's
  ``meta``; the CLI writes its cells and an LM cell with the keys the
  module promises and no TPU constant.

The placeholder process group is brought up for this module and torn
down after it.
"""
import json
import math
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as r_get_config
from repro.configs.base import ShapeSpec as RShapeSpec
from repro.launch import costs as rcosts
from repro.training import steps as rsteps
from repro_torch.configs import ARCHS, LM_SHAPES, get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.launch import costs, mesh as mesh_mod

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def fake8():
    mesh_mod.fake_process_group(8)
    yield
    dist.destroy_process_group()


@pytest.mark.parametrize("shape", [s.name for s in LM_SHAPES])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_flops_equal_the_reference(arch, shape):
    cfg, rcfg = get_config(arch), r_get_config(arch)
    assert costs.matmul_param_count(cfg) == rcosts.matmul_param_count(rcfg)
    sh = next(s for s in LM_SHAPES if s.name == shape)
    rsh = RShapeSpec(sh.name, sh.seq_len, sh.global_batch, sh.kind)
    assert costs.model_flops(cfg, sh) == rcosts.model_flops(rcfg, rsh)


def _deep(arch):
    cfg = get_config(arch).smoke()
    if cfg.family == "encdec":
        return cfg.replace(n_layers=3, encdec=type(cfg.encdec)(3, 0.5))
    return cfg.replace(n_layers=6)


@pytest.mark.parametrize("arch", ["tinyllama-1.1b", "zamba2-1.2b",
                                  "seamless-m4t-medium"])
def test_depth_probe_equals_full_depth(arch, fake8):
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.training.steps import build_cell
    mesh = mesh_mod.make_local_mesh(2, 4)
    cfg = _deep(arch)
    shape = ShapeSpec("t", 64, 8, "train")
    probe = costs.probe_costs(cfg, shape, mesh)
    cell = build_cell(cfg, shape, mesh, device="meta")
    with FlopCounterMode(display=False) as fc:
        cell.fn(*costs.cell_args(cell, cfg))
    assert probe.global_flops == pytest.approx(fc.get_total_flops(),
                                               rel=1e-6)
    direct = costs.run_probe(cfg, shape, mesh)
    assert probe.flops == pytest.approx(direct["flops"], rel=1e-6)
    assert probe.flops > 0 and fc.get_total_flops() > 0


@pytest.mark.parametrize("arch", ["llama3-8b", "qwen3-moe-30b-a3b"])
def test_argument_bytes_equal_the_reference(arch):
    from repro_torch.training.steps import build_cell, local_bytes
    mesh = AbstractMesh((2, 4), ("data", "model"))
    cfg, rcfg = get_config(arch).smoke(), r_get_config(arch).smoke()
    for kind in ("train", "prefill", "decode"):
        sh = ShapeSpec("t", 64, 8, kind)
        cell = build_cell(cfg, sh, mesh, device="meta")
        got = sum(local_bytes(a, s) for a, s in zip(cell.args,
                                                    cell.in_shardings))
        rcell = rsteps.build_cell(rcfg, RShapeSpec("t", 64, 8, kind), mesh)
        want = sum(
            math.prod(s.shard_shape(a.shape)) * np.dtype(a.dtype).itemsize
            for a, s in zip(jax.tree.leaves(rcell.args),
                            jax.tree.leaves(rcell.in_shardings)))
        assert got == want, kind


def test_tp_mlp_records_megatron_all_reduces(fake8):
    """x → rms_norm → SwiGLU with w1/w3 column- and w2 row-split over a
    4-rank model axis → the block's output replicated, and its backward
    to x's gradient whole (as the layer below takes it): one all-reduce
    forward and one backward.  DTensor carries the gradient as a partial
    sum until it is taken whole, every backward op being linear in it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from repro_torch.distributed import sharding as shd
    from repro_torch.models.layers import rms_norm
    mesh = mesh_mod.make_local_mesh(1, 4)
    B, S, D, F = 2, 16, 64, 256

    def dt(shape, pl):
        local = list(shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] //= mesh.size(i)
        return DTensor.from_local(torch.zeros(local, device="meta"), mesh,
                                  pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(
                                      shape, device="meta").stride())

    R = Replicate()
    x = dt((B, S, D), [R, R]).requires_grad_()
    ln = dt((D,), [R, R])
    w1, w3 = (dt((D, F), [R, Shard(1)]).requires_grad_() for _ in range(2))
    w2 = dt((F, D), [R, Shard(0)]).requires_grad_()
    with costs.CostProbe() as probe:
        h = rms_norm(x, ln)
        y = (torch.nn.functional.silu(h @ w1) * (h @ w3)) @ w2
        y = y.redistribute(mesh, [R, R])
        gx = torch.autograd.grad(y.sum(), (x, w1, w3, w2))[0]
        gx = gx.redistribute(mesh, [R, R])
    got = probe.result()["coll"]
    assert got["counts"] == {"all-reduce": 2}
    payload = B * S * D * 4
    hlo = "\n".join(
        f"  %all-reduce.{i} = f32[{B},{S},{D}]{{2,1,0}} all-reduce(%p{i}), "
        "channel_id=1" for i in range(2))
    want = rcosts.parse_collectives(hlo, 4)
    assert got["payload_bytes"] == want["payload_bytes"] == 2 * payload
    assert got["link_bytes"] == pytest.approx(want["link_bytes"], rel=1e-12)
    assert got["bytes_by_kind"] == want["bytes_by_kind"]
    assert shd.axis_sizes(mesh) == {"data": 1, "model": 4}


@pytest.mark.parametrize("mode", ["threefry", "hbm_uniforms"])
def test_generation_cell_meta_and_no_collectives(mode):
    """The reference's meta for the 16 × 16 mesh (its lowering needs 256
    host devices; ``meta`` is arithmetic), and no collective."""
    from repro_torch.core.distributed_gen import build_generation_cell
    cell = build_generation_cell(256, "1t", mode=mode)
    step_edges = (1 << 24) * 256
    assert cell.meta == {"edges": step_edges, "target_edges": 1.0e12,
                         "steps_needed": int(np.ceil(1.0e12 / step_edges)),
                         "mode": mode}
    assert costs.summarize_collectives([])["payload_bytes"] == 0
    assert cell.costs["bytes"] > 0


def test_cli_writes_cells(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    for extra in (["--arch", "tinyllama-1.1b", "--shape", "decode_32k"],
                  ["--arch", "tinyllama-1.1b", "--shape", "long_500k"],
                  ["--graphgen", "--mesh", "both"]):
        r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                            "--out", str(tmp_path)] + extra, env=env,
                           capture_output=True, text=True, timeout=600,
                           cwd=ROOT)
        assert r.returncode == 0, r.stderr[-3000:]
    cells = {p.name: json.loads(p.read_text())
             for p in tmp_path.glob("*.json")}
    assert sorted(cells) == [
        "graphgen__1t__multi.json", "graphgen__1t__single.json",
        "tinyllama-1.1b__decode_32k__single.json",
        "tinyllama-1.1b__long_500k__single.json"]
    lm = cells["tinyllama-1.1b__decode_32k__single.json"]
    assert lm["status"] == "ok"
    for key in ("config", "memory_analysis", "probe", "roofline",
                "collectives", "method"):
        assert key in lm
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "model_flops", "counted_flops_total", "useful_ratio"):
        assert key in lm["roofline"]
    assert lm["roofline"]["chips"] == 256
    ma = lm["memory_analysis"]
    assert ma["peak_bytes_per_device"] == (ma["argument_bytes"]
                                           + ma["temp_bytes"])
    skipped = cells["tinyllama-1.1b__long_500k__single.json"]
    assert skipped["status"] == "skipped"
    assert skipped["reason"] == r_get_config("tinyllama-1.1b") \
        .supports_shape(RShapeSpec("long_500k", 524288, 1, "decode"))[1]
    for mk, chips in (("single", 256), ("multi", 512)):
        g = cells[f"graphgen__1t__{mk}.json"]
        assert g["status"] == "ok" and g["roofline"]["chips"] == chips
        assert g["collectives"]["payload_bytes"] == 0
        assert g["roofline"]["collective_s"] == 0.0
        assert g["roofline"]["edges_per_s_roofline"] > 0
    text = json.dumps(cells)
    for const in ("197000000000000", "819000000000", "1.97e+14",
                  "8.19e+11", "v5e"):
        assert const not in text
