"""Declarative parameters: ``ParamDef`` trees and their random weights.

Model builders produce nested dicts (and, for unstacked layers, lists) of
:class:`ParamDef` — shape, logical dims, init — as in the JAX package.
``init_params`` materialises the same weights the JAX package's
``init_params`` makes from the same key: leaves are taken in jax's tree
order (dict keys sorted, lists in order), the key is split into one key
per leaf, and each ``normal`` leaf is ``random.normal(key, shape) * scale``
in float32, then cast to its dtype.  Leaves are drawn one at a time, and
a leaf in pieces of ``INIT_PIECE`` elements (``random.normal_range``),
so the temporaries of the threefry draw and of the normal's float math
stay the size of a piece: a full-width model's largest leaf (rwkv6-7b's
``(32, 4096, 14336)`` ``ck``) would otherwise hold ~24 bytes an element
of temporaries beside the weights.
``abstract_params`` gives each leaf's shape and dtype without drawing it,
``param_dims`` its logical dims (``distributed.sharding`` resolves
them to mesh axes).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch import random as trandom


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dims: Tuple[Optional[str], ...]
    init: str = "normal"          # normal | zeros | ones | constant
    scale: Optional[float] = None  # default: 1/sqrt(fan_in) for 'normal'
    value: float = 0.0             # for 'constant'
    dtype: Optional[str] = None    # override model dtype (e.g. 'float32')

    def __post_init__(self):
        if len(self.shape) != len(self.dims):
            raise ValueError(f"shape {self.shape} and dims {self.dims} "
                             "differ in rank")


def torch_dtype(name) -> torch.dtype:
    """``"bfloat16"`` → ``torch.bfloat16`` (a torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, str(name))


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not made yet (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


def leaves(tree) -> List[Any]:
    """Leaves in jax's flattening order: dict keys sorted, lists in order
    (a ``TensorSpec`` is a leaf)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree):
    """``fn`` on every leaf, in jax's order, keeping the dict/list
    structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, TensorSpec):
        return [tree_map(fn, t) for t in tree]
    return fn(tree)


def _leaf_dtype(d: ParamDef, dtype) -> torch.dtype:
    return torch_dtype(d.dtype if d.dtype is not None else dtype)


def abstract_params(defs, dtype):
    """``defs`` → the same tree of ``TensorSpec`` leaves."""
    return tree_map(lambda d: TensorSpec(d.shape, _leaf_dtype(d, dtype)),
                    defs)


def param_dims(defs):
    return tree_map(lambda d: d.dims, defs)


#: elements drawn at once in a ``normal`` leaf: on a card, and on the CPU
#: (whose pieces stay in cache, as ``random.bits`` takes them)
INIT_PIECE, INIT_CPU_PIECE = 1 << 26, 1 << 18


def _init_one(d: ParamDef, key: torch.Tensor, dtype, device) -> torch.Tensor:
    dt = _leaf_dtype(d, dtype)
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dt, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dt, device=device)
    if d.init == "constant":
        return torch.full(d.shape, d.value, dtype=dt, device=device)
    if d.init == "normal":
        fan_in = d.shape[0] if len(d.shape) == 1 else math.prod(d.shape[:-1])
        # stacked layer/expert dims don't contribute to fan-in
        n_stack = sum(1 for dim in d.dims[:-1] if dim in ("layers", "experts"))
        if n_stack and len(d.shape) > 1 + n_stack:
            fan_in = math.prod(d.shape[n_stack:-1])
        scale = d.scale if d.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
        out = torch.empty(d.shape, dtype=dt, device=device)
        flat = out.view(-1)
        piece = INIT_CPU_PIECE if out.device.type == "cpu" else INIT_PIECE
        for lo in range(0, flat.numel(), piece):
            hi = min(flat.numel(), lo + piece)
            flat[lo:hi] = trandom.normal_range(key, lo, hi, device) * scale
        return out
    raise ValueError(f"unknown init {d.init!r}")


def init_params(defs, key: torch.Tensor, dtype, device="cuda"):
    """The ``ParamDef`` tree ``defs`` → the same tree of tensors on
    ``device``, equal to the JAX package's ``init_params(defs, key,
    dtype)`` for the same key (within ``random.normal``'s float32
    rounding before the cast)."""
    keys = iter(trandom.split(key, len(leaves(defs))))
    return tree_map(lambda d: _init_one(d, next(keys), dtype, device), defs)
