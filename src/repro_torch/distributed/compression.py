"""Gradient compression: int8 quantization with error feedback, the port
of the JAX package's ``distributed/compression.py``.

For the pure data-parallel ``pod`` axis of the multi-pod mesh the
gradient all-reduce's payload dominates the links at low arithmetic
intensity.  ``compressed_psum`` quantizes each leaf symmetrically to int8
(scale = max|g|/127, a 4× payload cut against float32), all-reduces the
int8 values as int32 over the named mesh axis's process group, and
dequantizes; an error-feedback buffer carries the quantization residual
into the next step (Karimireddy et al., which keeps SGD/Adam converging).

The reference's quirk is kept: the result is the *mean* of the ranks'
scales times the summed ints (divided by the rank count), not the sum of
each rank's own dequantized values; error feedback absorbs the mismatch.

Trees are the port's dict/list trees (``models.params.tree_map``).
"""
from __future__ import annotations

import torch

from repro_torch.models.params import leaves, tree_map


def quantize_int8(g: torch.Tensor):
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_tree(grads, error_buf):
    """(grads + error) → (int8 tree, scales tree, new error buffer)."""
    out = []
    for g, e in zip(leaves(grads), leaves(error_buf)):
        g = g.to(torch.float32) + e
        q, s = quantize_int8(g)
        out.append((q, s, g - dequantize_int8(q, s)))
    parts = []
    for i in range(3):
        it = iter(t[i] for t in out)
        parts.append(tree_map(lambda _: next(it), grads))
    return tuple(parts)


def compressed_psum(grads, error_buf, mesh, axis: str = "pod"):
    """All-reduce mean of each rank's local ``grads`` over the mesh axis
    ``axis`` with int8 payloads (a collective: every rank of the axis's
    group calls it).  Returns (mean grads float32, new error buffer)."""
    import torch.distributed as dist
    group = mesh.get_group(axis)
    n = dist.get_world_size(group)
    q, s, e_new = compress_tree(grads, error_buf)
    deq = []
    for qq, ss in zip(leaves(q), leaves(s)):
        summed = qq.to(torch.int32)
        dist.all_reduce(summed, dist.ReduceOp.SUM, group=group)
        # the ranks' scales differ: the mean scale times the summed ints,
        # as the reference (error feedback absorbs the mismatch)
        s_mean = ss.clone()
        dist.all_reduce(s_mean, dist.ReduceOp.SUM, group=group)
        s_mean = s_mean / n
        deq.append(summed.to(torch.float32) * s_mean / n)
    it = iter(deq)
    return tree_map(lambda _: next(it), grads), e_new


def init_error_buffer(grads_like):
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)
