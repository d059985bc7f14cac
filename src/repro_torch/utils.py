"""Small shared utilities."""
from __future__ import annotations

import inspect
import math

import numpy as np
import torch


def parse_count(s: str) -> int:
    """'1e7', '10_000', '1<<20' style counts: the CLI's edge and row
    count grammar."""
    s = s.replace("_", "")
    if "<<" in s:
        a, b = s.split("<<")
        return int(a) << int(b)
    return int(float(s))


def accepts_kwarg(fn, name: str) -> bool:
    """True when ``fn`` can be called with keyword ``name``: threads
    optional engine kwargs (e.g. ``batch=``) through pluggable generator
    and aligner interfaces.  A ``**kwargs`` catch-all accepts every
    name."""
    try:
        params = inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return False
    if name in params:
        return True
    return any(p.kind is inspect.Parameter.VAR_KEYWORD
               for p in params.values())


def call_with_optional_kwargs(fn, *args, **optional):
    """``fn(*args)`` plus whichever of ``optional`` are non-None and in
    ``fn``'s signature."""
    kwargs = {k: v for k, v in optional.items()
              if v is not None and accepts_kwarg(fn, k)}
    return fn(*args, **kwargs)


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------
# The port's trees are nested dicts, lists, tuples and NamedTuples, as the
# JAX package's pytrees are; a module with a ``tree()`` method (the dense
# LM's weights) stands for the tree it returns.  Leaves come in jax's
# flattening order (dict keys sorted, sequences in order), named as
# ``jax.tree_util.keystr`` names them.

def _is_spec(x) -> bool:
    # a NamedTuple of a shape and a dtype (``TensorSpec``) is a leaf
    return isinstance(x, tuple) and getattr(x, "_fields", None) == (
        "shape", "dtype")


def tree_flatten_with_path(tree, prefix: str = ""):
    """``[(keystr, leaf), ...]`` in jax's leaf order."""
    if callable(getattr(tree, "tree", None)):
        tree = tree.tree()
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in tree_flatten_with_path(tree[k], f"{prefix}[{k!r}]")]
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not _is_spec(tree):
        return [x for k in tree._fields
                for x in tree_flatten_with_path(getattr(tree, k),
                                                f"{prefix}.{k}")]
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [x for i, t in enumerate(tree)
                for x in tree_flatten_with_path(t, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree)]


def _numel(x) -> int:
    return math.prod(x.shape)


def _itemsize(x) -> int:
    dt = x.dtype
    return dt.itemsize if isinstance(dt, (torch.dtype, np.dtype)) \
        else np.dtype(dt).itemsize


def tree_size(tree) -> int:
    return sum(_numel(x) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    return sum(_numel(x) * _itemsize(x) for x in tree_leaves(tree))


def split_by_tree(rng, tree):
    """One threefry key per leaf, in jax's leaf order, in ``tree``'s
    structure (a module stands for its ``tree()``)."""
    from repro_torch import random as trandom
    keys = iter(trandom.split(rng, len(tree_leaves(tree))))
    return _map(lambda _: next(keys), tree)


def cast_tree(tree, dtype):
    """Floating leaves cast to ``dtype``; others kept."""
    return _map(lambda x: x.to(dtype) if x.is_floating_point() else x, tree)


def assert_finite(tree, name="tree"):
    for path, leaf in tree_flatten_with_path(tree):
        if leaf.is_floating_point():
            if not bool(torch.isfinite(leaf).all()):
                raise AssertionError(f"non-finite values in {name}{path}")


def _map(fn, tree):
    if callable(getattr(tree, "tree", None)):
        tree = tree.tree()
    if isinstance(tree, dict):
        return {k: _map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, tuple) and hasattr(tree, "_fields") \
            and not _is_spec(tree):
        return type(tree)(*(_map(fn, t) for t in tree))
    if isinstance(tree, (list, tuple)) and not _is_spec(tree):
        return [_map(fn, t) for t in tree]
    return fn(tree)
