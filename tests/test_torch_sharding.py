"""The port's sharding rules against the JAX package's, exactly.

``attention_plan``, ``make_rules``, ``resolve_spec``, ``batch_shardings``
and ``opt_state_shardings`` of ``repro_torch.distributed.sharding`` /
``training.steps`` against ``repro.distributed.sharding`` /
``repro.training.steps``, for every architecture on the (2, 4),
(16, 16) and (2, 16, 16) meshes, with ``seq_shard``, ``dp2d``,
``moe_path="ep"`` and ``fsdp`` each on: every parameter, cache entry and
input of every shape gets the reference's spec, and every parameter and
optimizer-state leaf the reference's local shard shape
(``NamedSharding.shard_shape``).  The rules need only each mesh's
``{axis: size}``: ``jax.sharding.AbstractMesh`` on the JAX side, the same
object on the port's.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec as P

from repro.configs import get_config as r_get_config
from repro.distributed import sharding as rshd
from repro.models.model import Model as RModel
from repro.training import optimizer as ropt
from repro.training import steps as rsteps
from repro_torch.configs import ARCHS, LM_SHAPES, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.models import Model
from repro_torch.models.params import leaves
from repro_torch.training import optimizer as opt
from repro_torch.training import steps

MESHES = {"2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
VARIANTS = {"base": {}, "seq_shard": {"seq_shard": True},
            "dp2d": {"dp2d": True}, "ep": {"moe_path": "ep"},
            "fsdp": {"fsdp": True}}


def _spec(p) -> tuple:
    return tuple(p)


def _defs(m):
    """(dims, shape) of every parameter, in jax's leaf order."""
    return [(d.dims, tuple(d.shape)) for d in m]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_equal_the_reference(arch, mesh_name, variant):
    mesh = AbstractMesh(*MESHES[mesh_name])
    cfg = get_config(arch).replace(**VARIANTS[variant])
    rcfg = r_get_config(arch).replace(**VARIANTS[variant])
    tp = mesh.shape["model"]
    assert shd.attention_plan(cfg.n_heads, cfg.n_kv_heads,
                              cfg.resolved_head_dim, tp) == \
        rshd.attention_plan(rcfg.n_heads, rcfg.n_kv_heads,
                            rcfg.resolved_head_dim, tp)
    rules, rrules = shd.make_rules(cfg, mesh), rshd.make_rules(rcfg, mesh)
    assert rules == rrules

    model, rmodel = Model(cfg, "cpu"), RModel(rcfg)
    pdefs = _defs(leaves(model.param_defs()))
    rdefs = _defs(jax.tree.leaves(rmodel.param_defs()))
    assert pdefs == rdefs
    specs = [shd.resolve_spec(d, s, rules, mesh) for d, s in pdefs]
    assert specs == [_spec(rshd.resolve_spec(d, s, rrules, mesh))
                     for d, s in rdefs]
    # local shard shapes of the parameters and of the ZeRO state
    p_sh = leaves_sh(shd.tree_shardings(model.param_dims(),
                                        model.abstract_params(), rules,
                                        mesh))
    assert [sh.shard_shape(s) for sh, (_, s) in zip(p_sh, pdefs)] == \
        [NamedSharding(mesh, P(*sp)).shard_shape(s)
         for sp, (_, s) in zip(specs, pdefs)]
    o_sh = steps.opt_state_shardings(
        opt.abstract_opt_state(model.abstract_params()), model.param_dims(),
        rules, mesh)
    ro_sh = rsteps.opt_state_shardings(
        ropt.abstract_opt_state(rmodel.abstract_params()),
        rmodel.param_dims(), rrules, mesh)
    for part in ("master", "mu", "nu"):
        got = leaves_sh(getattr(o_sh, part))
        want = jax.tree.leaves(getattr(ro_sh, part))
        assert [g.spec for g in got] == [_spec(w.spec) for w in want]
        assert [g.shard_shape(s) for g, (_, s) in zip(got, pdefs)] == \
            [w.shard_shape(s) for w, (_, s) in zip(want, rdefs)]
    assert o_sh.step.spec == _spec(ro_sh.step.spec) == ()

    # caches and inputs of every shape
    cdims, rcdims = model.cache_dims(), rmodel.cache_dims()
    assert cdims == rcdims
    for shape in LM_SHAPES:
        if shape.kind != "train":
            cache = model.cache_abstract(shape.global_batch, shape.seq_len)
            rcache = rmodel.cache_abstract(shape.global_batch,
                                           shape.seq_len)
            assert sorted(cache) == sorted(rcache)
            for k in cache:
                assert tuple(cache[k].shape) == tuple(rcache[k].shape), k
                assert shd.resolve_spec(cdims[k], cache[k].shape, rules,
                                        mesh) == _spec(rshd.resolve_spec(
                                            rcdims[k], rcache[k].shape,
                                            rrules, mesh)), (shape.name, k)
        inputs = model.input_specs(shape)
        got = steps.batch_shardings(inputs, mesh, rules)
        want = rsteps.batch_shardings(rmodel.input_specs(shape), mesh,
                                      rrules)
        assert sorted(got) == sorted(want)
        assert {k: v.spec for k, v in got.items()} == \
            {k: _spec(v.spec) for k, v in want.items()}, shape.name


def leaves_sh(tree) -> list:
    return steps._spec_leaves(tree)


def test_resolve_spec_divisibility_and_uniqueness():
    """The reference's own cases (``tests/test_distributed.py``)."""
    mesh = AbstractMesh((2, 4), ("data", "model"))
    rules = {"vocab": ("model",), "heads": ("model",),
             "batch": (("data",),)}
    assert shd.resolve_spec(("vocab", None), (64, 7), rules, mesh) == \
        ("model",)
    assert shd.resolve_spec(("vocab", None), (65, 7), rules, mesh) == ()
    assert shd.resolve_spec(("vocab", "heads"), (64, 8), rules, mesh) == \
        ("model",)
    assert shd.attention_plan(32, 8, 128, 16) == "heads"
    assert shd.attention_plan(32, 32, 64, 16) == "kv"
    assert shd.attention_plan(40, 8, 128, 16) == "head_dim"
    assert shd.attention_plan(6, 3, 7, 16) == "replicate"


class _Mesh:
    """A mesh's axis names and sizes, as ``placements`` reads them."""
    mesh_dim_names = ("pod", "data", "model")
    shape = (2, 2, 4)


def test_placements_map_a_spec_onto_mesh_dims():
    from torch.distributed.tensor import Replicate, Shard
    m = _Mesh()
    assert shd.placements(("model", None, ("pod", "data")), m) == \
        [Shard(2), Shard(2), Shard(0)]
    assert shd.placements((), m) == [Replicate()] * 3
    with pytest.raises(ValueError, match="out of the mesh's order"):
        shd.placements((("data", "pod"),), m)
    assert shd.shard_shape((("pod", "data"), "model"), (8, 12), m) == (2, 3)
    with pytest.raises(ValueError, match="does not split"):
        shd.shard_shape(("model",), (6,), m)
    np.testing.assert_equal(shd.axis_sizes(m), {"pod": 2, "data": 2,
                                                "model": 4})
