"""The train step and one cell's shardings: the port of the JAX package's
``training/steps.py``.

``make_train_step(model, hp, mesh=None)`` returns ``full_step(params,
opt_state, batch) → (params, opt_state, {"loss", "lr", "grad_norm"})``:
the loss and its gradients by torch autograd, microbatched gradient
accumulation in float32, then the AdamW update
(``optimizer.apply_update``).  The step runs eagerly and updates
``params`` (an ``LM``) and ``opt_state`` in place; the returned ones are
the same objects.

With ``cfg.microbatches = M > 1`` every batch entry (``tokens``,
``labels``, and ``patches`` or ``frames`` where the family takes them)
splits M ways along its first dim; each microbatch's gradients (in the
params' dtype, as the reference differentiates bf16 params) are cast to
float32 and summed, the sum is divided by M and the loss averaged.
Gradients come out in the reference's tree: one stacked ``(L, ...)``
leaf each with ``cfg.scan_layers``.

With ``mesh`` (a ``DeviceMesh``) the weights, optimizer state and batch
are DTensors laid out by the rules (``build_cell``; ``place`` lays out
a tree): the loss runs under ``sharding.mesh_scope``, each microbatch is
the reference's rows, laid out again as the batch was, and each float32
gradient is redistributed to its first moment's placement before it is
summed or used: ZeRO-2's accumulator, placed like ``mu``, whose extra
``data`` sharding (``opt_state_shardings``, ZeRO-1) turns the gradient's
reduction into a reduce-scatter.  The new weights are gathered back to
the weights' placements.  The loss and the metrics come back as plain
tensors, the same on every rank.

``build_cell(cfg, shape, mesh)`` assembles one (arch × shape × mesh)
cell: the step (train, prefill or decode), its abstract arguments and
their shardings, as the dry-run takes them.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed import sharding as shd
from repro_torch.models.model import BATCH_DIMS, Model
from repro_torch.models.params import (TensorSpec, leaves, torch_dtype,
                                       tree_map)
from repro_torch.training import optimizer as opt_mod


def _on(x, device, dtype) -> torch.Tensor:
    """A batch entry on ``device``: float inputs (the VLM's ``patches``,
    the encdec's ``frames``) in the params' dtype, as the reference's
    forward casts them; ``tokens``/``labels`` keep their int dtype."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, dtype if x.is_floating_point() else None)


def _is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _plain(x):
    """A DTensor's full value as a plain tensor (a collective); anything
    else as it is."""
    return x.full_tensor() if _is_dtensor(x) else x


def _rows(x, i: int, M: int):
    """Microbatch ``i`` of ``M``: rows ``i·n .. (i+1)·n`` of ``x``'s
    first dim.  A DTensor's rows are gathered and laid out again as the
    batch was (the reference's microbatches are the same rows, whatever
    their sharding; a MoE's groups and capacity depend on them)."""
    n = x.shape[0] // M
    piece = x[i * n:(i + 1) * n]
    if not _is_dtensor(x):
        return piece
    return piece.redistribute(x.device_mesh, x.placements)


def make_train_step(model, hp: opt_mod.OptConfig, mesh=None):
    cfg = model.cfg
    pdt = torch_dtype(cfg.dtype)

    # ZeRO-2: the float32 gradient sum laid out like the first moment
    zero = None
    if mesh is not None:
        rules = shd.make_rules(cfg, mesh)
        o_abs = opt_mod.abstract_opt_state(model.abstract_params())
        zero = _spec_leaves(opt_state_shardings(o_abs, model.param_dims(),
                                                rules, mesh).mu)

    def loss_and_grads(params, batch):
        weights = leaves(params.tree())
        for w in weights:
            w.requires_grad_(True)
        loss = (model.loss(params, batch) if mesh is None
                 else model.loss(params, batch, mesh=mesh))
        return loss.detach(), torch.autograd.grad(loss, weights)

    def f32(grads) -> list:
        out = [g.to(torch.float32) for g in grads]
        if zero is not None:
            out = [g.redistribute(mesh, sh.placements())
                   for g, sh in zip(out, zero)]
        return out

    def train_step(params, batch):
        M = cfg.microbatches
        if M > 1:
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            gsum = None
            for i in range(M):
                mb = {k: _rows(v, i, M) for k, v in batch.items()}
                mloss, grads = loss_and_grads(params, mb)
                loss = loss + _plain(mloss)
                if gsum is None:
                    gsum = f32(grads)
                else:
                    for a, g in zip(gsum, f32(grads)):
                        a.add_(g)
                del grads
            return loss / M, [g.div_(M) for g in gsum]
        loss, grads = loss_and_grads(params, batch)
        return _plain(loss), f32(grads)

    def full_step(params, opt_state, batch, on_update=None):
        """``on_update``: called between the gradients and the update (the
        cost probe's phase mark)."""
        batch = {k: v if _is_dtensor(v) else _on(v, model.device, pdt)
                 for k, v in batch.items()}
        if mesh is not None:
            bsh = batch_shardings(batch, mesh, shd.make_rules(cfg, mesh))
            batch = {k: v if _is_dtensor(v) else shd.distribute(v, bsh[k])
                     for k, v in batch.items()}
        with shd.mesh_scope(cfg, mesh):
            loss, flat = train_step(params, batch)
            it = iter(flat)
            grads = tree_map(lambda _: next(it), params.tree())
            del flat, it
            if on_update is not None:
                on_update()
            new, opt_state, om = opt_mod.apply_update(grads, opt_state, hp,
                                                      pdt)
            del grads
            with torch.no_grad():
                for p, q in zip(leaves(params.tree()), leaves(new)):
                    if mesh is not None:
                        q = q.redistribute(p.device_mesh, p.placements)
                    p.copy_(q)
        om = {k: _plain(v) for k, v in om.items()}
        return params, opt_state, {"loss": loss, **om}

    return full_step


# ---------------------------------------------------------------------------
# Sharding assembly for one cell
# ---------------------------------------------------------------------------

def batch_shardings(batch_tree, mesh, rules):
    return {k: shd.NamedSharding(mesh, shd.resolve_spec(
        BATCH_DIMS[k], v.shape, rules, mesh)) for k, v in batch_tree.items()}


def opt_state_shardings(o_abs, p_dims, rules, mesh):
    """The optimizer state's shardings: each leaf's weight spec, and
    ``data`` on its first unsharded dim that ``data`` divides (ZeRO-1)."""
    sizes = shd.axis_sizes(mesh)

    def zero_sh(dims, leaf):
        spec = shd.resolve_spec(dims, leaf.shape, rules, mesh)
        entries = list(spec) + [None] * (len(leaf.shape) - len(spec))
        used = set()
        for e in entries:
            used.update(shd.spec_axes(e))
        if "data" not in used and "data" in sizes:
            dsize = sizes["data"]
            for i, (e, size) in enumerate(zip(entries, leaf.shape)):
                if e is None and size % dsize == 0 and size > 0:
                    entries[i] = "data"
                    break
        while entries and entries[-1] is None:
            entries.pop()
        return shd.NamedSharding(mesh, tuple(entries))

    def tree_sh(tree):
        return shd._map_dims(zero_sh, p_dims, tree)

    return opt_mod.OptState(
        master=tree_sh(o_abs.master), mu=tree_sh(o_abs.mu),
        nu=tree_sh(o_abs.nu), step=shd.NamedSharding(mesh, ()))


def place(tree, shardings):
    """``tree`` laid out by the ``NamedSharding`` tree ``shardings`` of
    its structure: plain tensors distributed from each rank's full copy,
    DTensors redistributed; an ``LM`` or ``OptState`` keeps its type."""
    from repro_torch.models.transformer import LM
    if isinstance(tree, LM):
        return LM(place(tree.tree(), shardings), tree.cfg)
    if isinstance(tree, opt_mod.OptState):
        return opt_mod.OptState(*(place(getattr(tree, k),
                                        getattr(shardings, k))
                                  for k in tree._fields))
    if isinstance(tree, dict):
        return {k: place(tree[k], shardings[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [place(t, s) for t, s in zip(tree, shardings)]
    if _is_dtensor(tree):
        return tree.redistribute(shardings.mesh, shardings.placements())
    return shd.distribute(tree, shardings)


class Cell(NamedTuple):
    fn: Any                    # the step: fn(*args)
    args: tuple                # abstract args (TensorSpec trees)
    in_shardings: tuple
    out_shardings: Any
    donate: tuple              # arguments the step updates in place


def build_cell(cfg: ModelConfig, shape: ShapeSpec, mesh,
               hp: Optional[opt_mod.OptConfig] = None,
               device="cuda") -> Cell:
    """One (arch × shape × mesh) cell: the step on ``mesh`` with its
    abstract arguments and their shardings; the train step's params
    argument is an ``LM``, the others trees."""
    model = Model(cfg, device)
    rules = shd.make_rules(cfg, mesh)
    hp = hp or opt_mod.OptConfig()

    p_abs = model.abstract_params()
    p_dims = model.param_dims()
    p_sh = shd.tree_shardings(p_dims, p_abs, rules, mesh)
    batch_abs = model.input_specs(shape)
    b_sh = batch_shardings(batch_abs, mesh, rules)
    replicated = shd.NamedSharding(mesh, ())

    if shape.kind == "train":
        o_abs = opt_mod.abstract_opt_state(p_abs)
        o_sh = opt_state_shardings(o_abs, p_dims, rules, mesh)
        fn = make_train_step(model, hp, mesh)
        metrics_sh = {"loss": replicated, "lr": replicated,
                      "grad_norm": replicated}
        return Cell(fn, (p_abs, o_abs, batch_abs),
                    (p_sh, o_sh, b_sh), (p_sh, o_sh, metrics_sh),
                    donate=(0, 1))

    cache_abs = model.cache_abstract(shape.global_batch, shape.seq_len)
    cache_dims = model.cache_dims()
    c_sh = {k: shd.NamedSharding(mesh, shd.resolve_spec(
        cache_dims[k], v.shape, rules, mesh)) for k, v in cache_abs.items()}

    if shape.kind == "prefill":
        def prefill(params, batch, cache):
            with torch.no_grad():
                return model.prefill(params, batch, cache, mesh=mesh)
        logits_sh = shd.NamedSharding(mesh, shd.resolve_spec(
            ("batch", "vocab"), (shape.global_batch, cfg.vocab), rules,
            mesh))
        return Cell(prefill, (p_abs, batch_abs, cache_abs),
                    (p_sh, b_sh, c_sh), (logits_sh, c_sh), donate=(2,))

    def decode(params, batch, cache):
        with torch.no_grad():
            return model.decode_step(params, batch, cache, mesh=mesh)
    tok_sh = shd.NamedSharding(mesh, shd.resolve_spec(
        ("batch",), (shape.global_batch,), rules, mesh))
    return Cell(decode, (p_abs, batch_abs, cache_abs),
                (p_sh, b_sh, c_sh), (tok_sh, c_sh), donate=(2,))


def local_bytes(abstract, shardings) -> int:
    """Bytes a rank holds of a tree of ``TensorSpec`` leaves laid out by
    ``shardings`` (a matching tree; the cache's host ``pos`` counts as
    the reference's int32 scalar)."""
    total = 0
    for spec, sh in zip(_spec_leaves(abstract), _spec_leaves(shardings)):
        n = 1
        for d in sh.shard_shape(spec.shape):
            n *= d
        total += n * torch.empty((), dtype=spec.dtype).element_size()
    return total


def _spec_leaves(tree) -> list:
    if isinstance(tree, (TensorSpec, shd.NamedSharding)):
        return [tree]
    if isinstance(tree, opt_mod.OptState):
        return [x for k in tree._fields for x in _spec_leaves(getattr(tree,
                                                                      k))]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _spec_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _spec_leaves(t)]
    return [tree]
