"""Checkpoints in the JAX package's on-disk format: the port of its
``distributed/checkpoint.py``, so that either package restores what the
other wrote.

* One ``leaf_XXXXX.npy`` per leaf of the tree, in jax's flattening order
  of the tree (an ``LM`` stands for its ``tree()``), and a
  ``manifest.json`` with the step and each leaf's ``keystr`` name, file,
  shape and dtype name.  bfloat16 is stored as its uint16 bit pattern
  (``.npy`` has no bfloat16), under the dtype name ``"bfloat16"``.
* Atomic: writes go to ``step_XXXXXXXX.tmp`` and are ``os.rename``d only
  after the manifest is fsynced, so a cut save is never taken for a
  whole one.
* Async: ``AsyncCheckpointer.save_async`` copies every leaf to host memory
  on the caller's thread before it returns (the train step updates the
  weights in place right after) and writes them on a daemon thread.
* Retention: the last ``keep`` checkpoints stay, older ones are deleted.

``restore`` reads into the structure of a tree like the one saved: each
tensor leaf comes back on that leaf's device, an ``LM`` as a new one
of the same config, a numpy leaf as numpy.  With ``shardings`` (a tree of
``sharding.NamedSharding`` of the same structure) each leaf comes back a
DTensor laid out on that sharding's mesh, whatever mesh saved it: the
elastic restore.

Under several processes a DTensor leaf is saved whole: every rank
gathers it (``full_tensor``, a collective), rank 0 writes, and the ranks
meet at a barrier before ``save`` returns.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Optional

import numpy as np
import torch

from repro_torch.utils import tree_flatten_with_path


def _host(leaf) -> tuple:
    """A leaf as (numpy array owning its memory, dtype name); a DTensor
    gathered whole."""
    from torch.distributed.tensor import DTensor
    if isinstance(leaf, DTensor):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return t.numpy(), str(t.numpy().dtype)
    arr = np.array(leaf)
    if arr.dtype.name == "bfloat16":
        return arr.view(np.uint16), "bfloat16"
    return arr, str(arr.dtype)


def _leaf_filename(i: int) -> str:
    return f"leaf_{i:05d}.npy"


def _snapshot(tree) -> list:
    return [(name, *_host(leaf))
            for name, leaf in tree_flatten_with_path(tree)]


def _write(ckpt_dir: str, step: int, snap: list, keep: int) -> str:
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "leaves": []}
    for i, (name, arr, dtype_name) in enumerate(snap):
        np.save(os.path.join(tmp, _leaf_filename(i)), arr)
        manifest["leaves"].append(
            {"name": name, "file": _leaf_filename(i),
             "shape": list(arr.shape), "dtype": dtype_name})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _gc(ckpt_dir, keep)
    return final


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


def save(ckpt_dir: str, step: int, tree, keep: int = 3) -> str:
    """Synchronous atomic save.  Returns the final directory path.  Under
    a process group, rank 0 writes and every rank waits for it."""
    import torch.distributed as dist
    snap = _snapshot(tree)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    if _rank() == 0:
        final = _write(ckpt_dir, step, snap, keep)
    if dist.is_initialized():
        dist.barrier()
    return final


class AsyncCheckpointer:
    """Snapshot on the caller thread, serialize on a daemon thread."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree):
        self.wait()
        snap = _snapshot(tree)
        if _rank() != 0:     # rank 0 writes for every rank
            return

        def work():
            try:
                _write(self.ckpt_dir, step, snap, self.keep)
            except BaseException as e:  # noqa: BLE001 — surfaced via wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")
             and os.path.exists(os.path.join(ckpt_dir, d, "manifest.json"))]
    return max(steps) if steps else None


def _load(path: str, dtype_name: str, like):
    arr = np.load(path)
    if isinstance(like, torch.Tensor):
        if dtype_name == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        return t.to(like.device)
    if dtype_name == "bfloat16":
        # a numpy tree of bfloat16 leaves (ml_dtypes) views the bits back
        return arr.view(np.asarray(like).dtype)
    return arr


def _unflatten(like, it):
    if callable(getattr(like, "tree", None)):
        return type(like)(_unflatten(like.tree(), it), like.cfg)
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(getattr(like, k), it)
                            for k in like._fields))
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(t, it) for t in like)
    return next(it)


def restore(ckpt_dir: str, tree_like, step: Optional[int] = None,
            shardings=None):
    """Restore into the structure of ``tree_like``.  → (tree, step).
    ``shardings``: a ``NamedSharding`` tree of the same structure, onto
    whose meshes the leaves are laid out (elastic re-sharding)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = tree_flatten_with_path(tree_like)
    if len(leaves) != len(manifest["leaves"]):
        raise ValueError(f"{d} holds {len(manifest['leaves'])} leaves, the "
                         f"tree {len(leaves)}")
    sh = None
    if shardings is not None:
        from repro_torch.distributed.sharding import distribute
        from repro_torch.training.steps import _spec_leaves
        sh = _spec_leaves(shardings)
        if len(sh) != len(leaves):
            raise ValueError(f"{len(sh)} shardings for {len(leaves)} leaves")
    out = []
    for i, ((name, like), meta) in enumerate(zip(leaves,
                                                 manifest["leaves"])):
        if list(meta["shape"]) != list(like.shape):
            raise ValueError(f"{name}: {meta['shape']} in {d}, "
                             f"{list(like.shape)} in the tree")
        t = _load(os.path.join(d, meta["file"]), meta["dtype"], like)
        if sh is not None:
            t = distribute(torch.as_tensor(t), sh[i])
        out.append(t)
    return _unflatten(tree_like, iter(out)), step


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
