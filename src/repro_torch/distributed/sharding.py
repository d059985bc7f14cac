"""Logical-axis sharding with divisibility fallback: the port of the JAX
package's ``distributed/sharding.py``, on DTensor.

The production mesh is fixed — ``(16, 16) ("data", "model")`` single-pod,
``(2, 16, 16) ("pod", "data", "model")`` multi-pod — while the ten
architectures have head counts, KV widths and vocab sizes that do not all
divide 16.  Every parameter and activation dim carries a *logical* name,
and this module resolves logical names to mesh axes per model:

* each logical name has an ordered list of candidate mesh axes;
* a candidate is taken only if the dim's size divides by the (product of
  the) mesh axes and no axis is already used by another dim of the same
  tensor;
* otherwise the next candidate, or replication.

Attention gets a per-model *plan* (:func:`attention_plan`): shard the KV
heads when they divide the ``model`` axis, else shard the query heads and
replicate K/V, else shard head_dim (the contraction then ends in an extra
all-reduce), else replicate.

The rules and ``resolve_spec`` are pure functions of a mesh's ``{axis:
size}`` (``axis_sizes``: a ``DeviceMesh``, or any object whose ``shape``
maps axis names to sizes), and give the reference's ``PartitionSpec`` as
a tuple: one entry a tensor dim, an axis name, a tuple of axis names or
None, trailing Nones dropped.  ``placements`` maps such a spec onto a
``DeviceMesh`` as one DTensor placement a mesh dim (``Shard(d)`` where
tensor dim d takes the axis, else ``Replicate()``).  A tensor dim over
several axes (``("pod", "data")``) is split major to minor in the order
the spec lists them, as a ``PartitionSpec`` splits it; DTensor splits a
dim held by several mesh dims in mesh order, so the axes of one entry
must come in mesh order (every rule lists them so).

``constrain(x, dims)`` is ``with_sharding_constraint``'s counterpart:
under ``active_mesh`` and ``activation_rules``, a DTensor ``x`` is
redistributed to the placements its logical dims resolve to; anything
else passes through.
"""
from __future__ import annotations

from types import SimpleNamespace
from typing import Dict, NamedTuple, Optional, Sequence, Tuple, Union

AxisCand = Union[str, Tuple[str, ...]]
Spec = Tuple[Optional[AxisCand], ...]

#: the active mesh and rules, process-wide and not per thread (the
#: reference keeps them per thread): on a card the autograd engine runs
#: the backward, and remat's recompute of each block, on a thread of its
#: own, which must see the forward's mesh and rules
_ctx = SimpleNamespace(mesh=None, rules=None)


def axis_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` (its ``mesh_dim_names``
    and ``shape``), or of an object whose ``shape`` is that mapping."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return dict(mesh.shape)


def set_mesh(mesh) -> None:
    _ctx.mesh = mesh


def get_mesh():
    return _ctx.mesh


class active_mesh:
    """Context manager: the mesh ``constrain`` resolves against."""

    def __init__(self, mesh):
        self.mesh = mesh

    def __enter__(self):
        self._prev = get_mesh()
        set_mesh(self.mesh)
        return self.mesh

    def __exit__(self, *exc):
        set_mesh(self._prev)
        return False


def set_rules(rules) -> None:
    _ctx.rules = rules


def get_rules():
    return _ctx.rules


class activation_rules:
    """Context manager: the rules ``constrain`` resolves with."""

    def __init__(self, rules):
        self.rules = rules

    def __enter__(self):
        self._prev = get_rules()
        set_rules(self.rules)
        return self.rules

    def __exit__(self, *exc):
        set_rules(self._prev)
        return False


# ---------------------------------------------------------------------------
# Rules
# ---------------------------------------------------------------------------

def _mesh_axis_size(sizes: Dict[str, int], cand: AxisCand) -> int:
    if isinstance(cand, str):
        return sizes.get(cand, 0)
    size = 1
    for a in cand:
        if a not in sizes:
            return 0
        size *= sizes[a]
    return size


def attention_plan(n_heads: int, n_kv: int, head_dim: int, tp: int) -> str:
    """'kv' | 'heads' | 'head_dim' | 'replicate' — see the module
    docstring."""
    if n_kv % tp == 0:
        return "kv"
    if n_heads % tp == 0:
        return "heads"
    if head_dim % tp == 0:
        return "head_dim"
    return "replicate"


def make_rules(cfg, mesh) -> Dict[str, Tuple[AxisCand, ...]]:
    """Logical dim → ordered mesh-axis candidates, specialised per
    model."""
    tp = axis_sizes(mesh).get("model", 1)
    plan = attention_plan(cfg.n_heads, cfg.n_kv_heads or cfg.n_heads,
                          cfg.resolved_head_dim, tp)
    rules: Dict[str, Tuple[AxisCand, ...]] = {
        "layers": (),
        "experts": (),          # looped over in the tp MoE path
        "embed": (),
        "embed_out": ("model",),
        "vocab": ("model",),
        "mlp": ("model",),
        "batch": (("pod", "data"), "data"),
        "seq": (),
        "kv_seq": (),           # the cache's sequence dim (see below)
        "conv": (),
        "lora": (),
        "groups": (),
        "ssm_state": (),
        "frames": (),
        "patches": (),
        "patch_dim": (),
    }
    if plan == "kv":
        rules.update(heads=("model",), kv_heads=("model",), head_dim=())
    elif plan == "heads":
        # KV heads indivisible: replicate the K/V weights, but shard the
        # KV *cache* along its sequence dim over 'model'
        rules.update(heads=("model",), kv_heads=(), head_dim=(),
                     kv_seq=("model",))
    elif plan == "head_dim":
        rules.update(heads=(), kv_heads=(), head_dim=("model",))
    else:
        rules.update(heads=(), kv_heads=(), head_dim=(), kv_seq=("model",))
    if getattr(cfg, "seq_shard", False):
        rules["seq"] = ("model",)
    if getattr(cfg, "dp2d", False):
        rules["batch"] = (("pod", "data", "model"), ("data", "model"),
                          ("pod", "data"), "data")
    if getattr(cfg, "moe_path", "tp") == "ep":
        # expert parallelism: each model rank owns E/tp full-width experts
        rules["experts"] = ("model",)
        rules["mlp"] = ()
    if getattr(cfg, "fsdp", False):
        # ZeRO-3: the weights' embed dims also over data.  Activations
        # list 'batch' first, which claims 'data' before 'embed' can
        rules["embed"] = ("data",)
    return rules


def resolve_spec(dims: Sequence[Optional[str]], shape: Sequence[int],
                 rules: Dict[str, Tuple[AxisCand, ...]], mesh) -> Spec:
    """Mesh axes for each dim, honouring divisibility and axis
    uniqueness: the reference's ``PartitionSpec`` as a tuple."""
    sizes = axis_sizes(mesh)
    used = set()
    out = []
    for dim, size in zip(dims, shape):
        assigned = None
        for cand in rules.get(dim, ()) if dim else ():
            axes = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used for a in axes):
                continue
            asize = _mesh_axis_size(sizes, cand)
            if asize == 0 or size % asize != 0:
                continue
            assigned = cand if isinstance(cand, str) else tuple(cand)
            used.update(axes)
            break
        out.append(assigned)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(entry) -> Tuple[str, ...]:
    """The mesh axes one spec entry names (none for None)."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def shard_shape(spec: Spec, shape: Sequence[int], mesh) -> Tuple[int, ...]:
    """The local shape of a tensor of ``shape`` laid out by ``spec``
    (``NamedSharding.shard_shape``)."""
    sizes = axis_sizes(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        for a in spec_axes(entry):
            if out[d] % sizes[a]:
                raise ValueError(f"dim {d} of {tuple(shape)} does not "
                                 f"split over {a!r} ({sizes[a]})")
            out[d] //= sizes[a]
    return tuple(out)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``: ``Shard(d)`` on each
    mesh dim that tensor dim d's entry names, ``Replicate()`` on the rest
    and on every mesh dim of size 1 (a shard of one is the whole; DTensor
    then runs the plain ops, where a size-1 ``Shard`` reduces another
    way)."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} lists its axes out of "
                             f"the mesh's order {names}")
        for i in idx:
            if mesh.shape[i] > 1:
                out[i] = Shard(d)
    return out


def mesh_placements(mesh, shard: dict, partial=()) -> list:
    """DTensor placements on ``mesh`` by axis: ``Shard(shard[axis])`` on
    the axes named, ``Partial()`` (a sum) on those in ``partial``,
    ``Replicate()`` on the rest and on every axis of size 1."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    return [Replicate() if n == 1
            else Shard(shard[a]) if a in shard
            else Partial() if a in partial else Replicate()
            for a, n in zip(mesh.mesh_dim_names, mesh.shape)]


class NamedSharding(NamedTuple):
    """A spec on a mesh (``jax.sharding.NamedSharding``'s counterpart)."""
    mesh: object
    spec: Spec

    def placements(self) -> list:
        return placements(self.spec, self.mesh)

    def shard_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        return shard_shape(self.spec, shape, self.mesh)


def _is_dims(x) -> bool:
    return isinstance(x, tuple) and all(isinstance(d, (str, type(None)))
                                        for d in x)


def _map_dims(fn, dims_tree, shape_tree):
    """``fn(dims, leaf)`` over a logical-dims tree and the shape tree of
    the same structure (dict keys sorted, lists in order)."""
    if _is_dims(dims_tree):
        return fn(dims_tree, shape_tree)
    if isinstance(dims_tree, dict):
        return {k: _map_dims(fn, dims_tree[k], shape_tree[k])
                for k in sorted(dims_tree)}
    return [_map_dims(fn, d, s) for d, s in zip(dims_tree, shape_tree)]


def tree_shardings(dims_tree, shape_tree, rules, mesh):
    """``NamedSharding`` tree from a logical-dims tree and a tree of
    shaped leaves (tensors or ``TensorSpec``s)."""
    return _map_dims(lambda dims, leaf: NamedSharding(
        mesh, resolve_spec(dims, leaf.shape, rules, mesh)),
        dims_tree, shape_tree)


def distribute(t, sharding: NamedSharding):
    """The full tensor ``t`` as a DTensor laid out by ``sharding``: each
    rank keeps its own shard of its own copy, no data is sent."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, sharding.mesh, sharding.placements(),
                             src_data_rank=None)


def constrain(x, dims: Sequence[Optional[str]]):
    """Redistribute the DTensor ``x`` to the placements its logical
    ``dims`` resolve to under the active mesh and rules; without both, or
    for a plain tensor, ``x`` itself (an empty-rules constraint would
    force replication)."""
    mesh, rules = get_mesh(), get_rules()
    if mesh is None or rules is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = resolve_spec(dims, x.shape, rules, mesh)
    target = placements(spec, mesh)
    if list(x.placements) == target:
        return x
    return x.redistribute(mesh, target)


def split_batch_heads(fn, args, arg_dims, out_dims):
    """``fn`` on each rank's batch rows and heads, in ``local_map``: the
    recurrent scans (Mamba2's SSD chunks, WKV6's) have no DTensor rule
    but split cleanly over both.  ``arg_dims`` / ``out_dims``: each
    tensor's (batch dim, head dim), None where it has none.  The batch
    dim goes over the batch's axes, the head dim over ``model`` when it
    divides; a plain tensor stands for a replicated one.  An input
    without a head dim (a batch-less one) used by every rank's heads
    (rows) gets a ``Partial`` gradient over those axes."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = next(a.device_mesh for a in args if isinstance(a, DTensor))
    rules, sizes = get_rules(), axis_sizes(mesh)
    bdim = next(i for i, (b, _) in enumerate(arg_dims) if b is not None)
    B = args[bdim].shape[arg_dims[bdim][0]]
    entry = resolve_spec(("batch",), (B,), rules, mesh)
    bax = spec_axes(entry[0] if entry else None)
    hdim = next(i for i, (_, h) in enumerate(arg_dims) if h is not None)
    H = args[hdim].shape[arg_dims[hdim][1]]
    hax = ("model" if "model" in sizes and "model" not in bax
           and H % sizes["model"] == 0 else None)

    def pl(dims, partial=()):
        b, h = dims
        shard = {a: b for a in bax} if b is not None else {}
        if h is not None and hax:
            shard[hax] = h
        return mesh_placements(mesh, shard, partial)

    def grad(dims):
        partial = (() if dims[1] is not None or not hax else (hax,)) + \
            (() if dims[0] is not None else tuple(bax))
        return pl(dims, partial)

    args = [a if isinstance(a, DTensor) else DTensor.from_local(
        a, mesh, [Replicate()] * mesh.ndim, run_check=False) for a in args]
    return local_map(fn, out_placements=tuple(pl(d) for d in out_dims),
                     in_placements=tuple(pl(d) for d in arg_dims),
                     in_grad_placements=tuple(grad(d) for d in arg_dims),
                     device_mesh=mesh, redistribute_inputs=True)(*args)


def unsplit(t, dim: int):
    """The DTensor ``t`` gathered along tensor dim ``dim`` (its other
    placements kept); anything else passes through."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(t, DTensor):
        return t
    dim %= t.dim()
    target = [Replicate() if p.is_shard() and p.dim == dim else p
              for p in t.placements]
    if target == list(t.placements):
        return t
    return t.redistribute(t.device_mesh, target)


def zero3_axes(rules) -> set:
    """The axes the batch may take (``rules["batch"]``'s candidates): a
    weight split over one of them (``fsdp``'s ``embed`` over ``data``;
    ``dp2d``'s ``model`` too) is ZeRO-3 sharded, and gathered for use."""
    return {a for cand in rules.get("batch", ()) for a in spec_axes(cand)}


def for_use(w):
    """The weight ``w`` as a layer uses it: a DTensor under the active
    mesh and rules gathered over the ZeRO-3 axes (``zero3_axes``), as
    XLA gathers an ``fsdp`` weight at its use; its gradient is then
    reduce-scattered back.  Anything else passes through."""
    mesh, rules = get_mesh(), get_rules()
    if mesh is None or rules is None:
        return w
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return w
    axes = zero3_axes(rules)
    target = [Replicate() if name in axes and p.is_shard() else p
              for name, p in zip(w.device_mesh.mesh_dim_names,
                                 w.placements)]
    if target == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, target)


class mesh_scope:
    """Context manager for a model step on ``mesh``: ``active_mesh``, the
    model's ``activation_rules`` (``make_rules(cfg, mesh)``) and DTensor's
    ``implicit_replication``, under which a plain tensor the step makes
    (positions, masks, zeros) stands for a replicated one.  Scopes nest:
    ``implicit_replication`` switches itself off on exit, so only the
    outermost scope enters it (remat recomputes blocks in the backward,
    outside the forward's scope).  A ``None`` mesh enters nothing."""

    def __init__(self, cfg, mesh):
        self.cfg, self.mesh = cfg, mesh

    def __enter__(self):
        import contextlib
        self._stack = contextlib.ExitStack()
        if self.mesh is not None:
            from torch.distributed.tensor import DTensor
            from torch.distributed.tensor.experimental import \
                implicit_replication
            self._stack.enter_context(active_mesh(self.mesh))
            self._stack.enter_context(
                activation_rules(make_rules(self.cfg, self.mesh)))
            if not DTensor._op_dispatcher._allow_implicit_replication:
                self._stack.enter_context(implicit_replication())
        return self.mesh

    def __exit__(self, *exc):
        return self._stack.__exit__(*exc)
