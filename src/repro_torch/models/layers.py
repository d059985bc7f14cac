"""Transformer building blocks: the port of the JAX package's
``models/layers.py``.

The math is plain functions on tensors, taking any object with the
weights as attributes; the weights live in small ``nn.Module``s
(``Attention``, ``SwiGLU``) whose parameters keep the JAX layouts (``wq``
``(D, H, Hd)``, ``wo`` ``(H, Hd, D)``, ...), so that a JAX parameter tree
maps onto them as a copy.  Attention uses the grouped
formulation: queries reshaped to ``(B, S, KV, G, Hd)``, so K/V are never
repeated.

The reference's layers import ``constrain`` and call it nowhere; the
blocks of ``transformer`` and ``encdec`` constrain.  ``multihead_attention``
keeps every path of the reference: causal self-attention (cache-less,
decode and prefill through a cache, and the flash kernel), bidirectional
self-attention (``causal=False``, the encoder's) and cross-attention
(``memory``, no RoPE on either side), and ``kv_positions``.

A KV cache is written in place (JAX returns new arrays): ``kv_cache``'s
tensors hold the new K/V after the call, and the returned pair is them.

Under a mesh (DTensor weights and activations, ``sharding.mesh_scope``)
these run in ``local_map``, each rank on its own shards, where DTensor
has no rule or one that gathers the operands whole: the attention core
(``_attention_mesh``: batch rows and query/KV heads, or head_dim with
the scores summed over its ranks, or a cache's rows flash-decoding
style), the head projections (``head_proj``/``head_unproj``:
column/row-parallel), the MLP (``_swiglu_mesh``) and the head (``logits_from``), the
vocab-parallel cross entropy (``_token_log_likelihood_mesh``) and
embedding (``embed_lookup``), and the cache writes
(``_write_cache_mesh``).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels import ops as kops
from repro_torch.models.params import ParamDef

KVCache = Tuple[torch.Tensor, torch.Tensor]


def _param(t: torch.Tensor) -> nn.Parameter:
    # no gradient until a train step asks for one (``training.steps``), so
    # scoring and serving build no autograd graph
    return nn.Parameter(t, requires_grad=False)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5
             ) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * w.float()).to(dt)


def group_norm_heads(x: torch.Tensor, w: torch.Tensor, n_heads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over per-head channels; x: (..., H*K), w: (H*K,).  The
    variance is the population one, as ``jnp.var`` takes it."""
    dt = x.dtype
    shp = x.shape
    x = x.reshape(shp[:-1] + (n_heads, shp[-1] // n_heads)).float()
    mu = x.mean(-1, keepdim=True)
    var = x.var(-1, keepdim=True, correction=0)
    x = (x - mu) * torch.rsqrt(var + eps)
    x = x.reshape(shp)
    return (x * w.float()).to(dt)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: torch.Tensor, head_dim: int, theta: float
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """positions: (...,) int → cos/sin (..., head_dim/2) float32."""
    half = head_dim // 2
    exps = torch.arange(half, dtype=torch.float32,
                        device=positions.device) / half
    # a Python base stays a kernel argument (no host-to-device copy) and
    # is taken in float32, as jax takes theta ** exps
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.float()[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor
               ) -> torch.Tensor:
    """x: (B, S, ..., Hd); cos/sin: (B, S, Hd/2) broadcast over head dims."""
    dt = x.dtype
    x = x.float()
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    for _ in range(x.dim() - cos.dim()):
        cos = cos[..., None, :]
        sin = sin[..., None, :]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def attention_defs(cfg, prefix_dims=("layers",), n_layers=None):
    """ParamDefs for one (stacked) attention block."""
    D, H, KV, Hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    L = (n_layers,) if n_layers is not None else ()
    pd = tuple(prefix_dims) if n_layers is not None else ()
    return {
        "wq": ParamDef(L + (D, H, Hd), pd + ("embed", "heads", "head_dim")),
        "wk": ParamDef(L + (D, KV, Hd), pd + ("embed", "kv_heads", "head_dim")),
        "wv": ParamDef(L + (D, KV, Hd), pd + ("embed", "kv_heads", "head_dim")),
        "wo": ParamDef(L + (H, Hd, D), pd + ("heads", "head_dim", "embed")),
    }


def _batch_placements(t) -> list:
    """``t``'s placements kept where they split its batch dim (0),
    replicated elsewhere."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in t.placements]


def head_proj(x, w, eq: str = "bsd,dhk->bshk"):
    """``einsum(eq, x, w)``: x (B, S, D) into heads through w (D, H, K).
    On DTensors (Megatron's column-parallel product) in ``local_map``:
    each rank its batch rows against its slice of the heads or of K, as
    ``w`` lies; DTensor's rule for the einsum flattens (H, K) and refuses
    a split K in some torch versions."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(w, DTensor):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    x = _replicated(x, mesh)
    xp = _batch_placements(x)
    wp = [p if p.is_shard() and p.dim in (1, 2) else Replicate()
          for p in w.placements]
    split = [i for i, p in enumerate(wp) if p.is_shard()]
    out = [wp[i].__class__(wp[i].dim + 1) if i in split else xp[i]
           for i in range(mesh.ndim)]
    from torch.distributed.tensor import Partial
    x_grad = [Partial() if i in split else xp[i] for i in range(mesh.ndim)]
    w_grad = [Partial() if xp[i].is_shard() else wp[i]
              for i in range(mesh.ndim)]
    return local_map(lambda a, b: torch.einsum(eq, a, b),
                     out_placements=out, in_placements=(xp, wp),
                     in_grad_placements=(x_grad, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def head_unproj(o, w):
    """``einsum("bshk,hkd->bsd", o, w)``: heads (B, S, H, K) back to
    (B, S, D) through w (H, K, D).  On DTensors (the row-parallel
    product) in ``local_map``: each rank its batch rows and its slice of
    the heads or of K, as ``w`` lies, the output a ``Partial`` sum over
    those ranks."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(w, DTensor):
        return torch.einsum("bshk,hkd->bsd", o, w)
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    wp = [p if p.is_shard() and p.dim in (0, 1) else Replicate()
          for p in w.placements]
    bp = _batch_placements(o)
    op = [wp[i].__class__(wp[i].dim + 2) if wp[i].is_shard() else bp[i]
          for i in range(mesh.ndim)]
    out = [Partial() if wp[i].is_shard() else bp[i]
           for i in range(mesh.ndim)]
    w_grad = [Partial() if bp[i].is_shard() else wp[i]
              for i in range(mesh.ndim)]
    return local_map(lambda a, b: torch.einsum("bshk,hkd->bsd", a, b),
                     out_placements=out, in_placements=(op, wp),
                     in_grad_placements=(op, w_grad), device_mesh=mesh,
                     redistribute_inputs=True)(o, w)


class Attention(nn.Module):
    """Grouped-query attention weights, in the JAX layouts."""

    def __init__(self, tree):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param(tree[name]))


# default query chunk: bounds the live (Qc, T) score block
ATTN_Q_CHUNK = 1024


def _attn_one_chunk(qc, k, v, qpos_c, kpos, scale,
                    scores_dtype=torch.float32, score_sum=None):
    """qc: (B,Qc,KV,G,Hd); k/v: (B,T,KV,Hd); positions → out (B,Qc,KV,G,Hd).

    The scores are the float32 product (the reference's
    ``preferred_element_type``) in ``scores_dtype``; the probabilities are
    cast to ``v``'s dtype before the PV product, as in the reference.
    ``score_sum``: sums a rank's part of the scores over the ranks that
    split head_dim (``_attention_mesh``)."""
    scores = torch.einsum("bskgh,btkh->bkgst", qc.float(), k.float())
    if score_sum is not None:
        scores = score_sum(scores)
    scores = scores.to(scores_dtype) * scale
    mask = kpos[:, None, None, None, :] <= qpos_c[:, None, None, :, None]
    neg = torch.finfo(scores_dtype).min / 2
    scores = scores.masked_fill(~mask, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def chunked_causal_attention(q, k, v, qpos, kpos, scale, q_chunk=ATTN_Q_CHUNK,
                             scores_dtype=torch.float32, score_sum=None):
    """Exact causal attention without materialising the full (S, T) score
    matrix: a loop over query chunks, so only a (Qc, T) block is live."""
    B, S, KV, G, Hd = q.shape
    if S <= q_chunk:
        return _attn_one_chunk(q, k, v, qpos, kpos, scale, scores_dtype,
                               score_sum)
    if S % q_chunk:
        raise ValueError(f"S={S} must be a multiple of q_chunk={q_chunk}")
    outs = [_attn_one_chunk(q[:, i:i + q_chunk], k, v, qpos[:, i:i + q_chunk],
                            kpos, scale, scores_dtype, score_sum)
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def _write_cache(kv_cache: KVCache, k, v, positions, cache_pos) -> KVCache:
    """Write the new K/V into the cache in place (DTensor caches: each
    rank its own rows, ``_write_cache_mesh``)."""
    from torch.distributed.tensor import DTensor
    ck, cv = kv_cache
    if isinstance(ck, DTensor):
        return _write_cache_mesh(kv_cache, k, v, positions, cache_pos)
    return _write_rows(ck, cv, k, v, positions, cache_pos)


def _write_rows(ck, cv, k, v, positions, cache_pos, seq_start: int = 0,
                T_all: Optional[int] = None) -> KVCache:
    """``_write_cache`` on a cache that holds rows ``seq_start ..
    seq_start + T`` of a ``T_all``-row cache (the whole cache by
    default): the write's rows that land there."""
    B, S = k.shape[:2]
    T = ck.shape[1]
    T_all = T if T_all is None else T_all
    if S == 1:
        # decode: per-slot write positions (continuous batching)
        rows = torch.arange(B, device=k.device)
        cols = positions[:, 0].long()
        if T == T_all:
            ck[rows, cols] = k[:, 0].to(ck.dtype)
            cv[rows, cols] = v[:, 0].to(cv.dtype)
            return ck, cv
        # a shard of the rows: the others keep their value (static shapes)
        cols = cols - seq_start
        mine = ((cols >= 0) & (cols < T))[:, None, None]
        cols = cols.clamp(0, T - 1)
        for c, new in ((ck, k), (cv, v)):
            c[rows, cols] = torch.where(mine, new[:, 0].to(c.dtype),
                                        c[rows, cols])
        return ck, cv
    # prefill: contiguous block write at cache_pos, the start clamped
    # so the block fits, as dynamic_update_slice clamps it
    start = min(max(int(cache_pos), 0), T_all - S)
    lo, hi = max(start, seq_start), min(start + S, seq_start + T)
    if lo < hi:
        ck[:, lo - seq_start:hi - seq_start] = k[:, lo - start:hi - start] \
            .to(ck.dtype)
        cv[:, lo - seq_start:hi - seq_start] = v[:, lo - start:hi - start] \
            .to(cv.dtype)
    return ck, cv


def _shard_offset(mesh, placements, dim: int, local_len: int) -> int:
    """The global index of a rank's first element along tensor dim
    ``dim`` split over the mesh dims whose placement shards it."""
    off = 0
    for i, p in enumerate(placements):
        if p.is_shard() and p.dim == dim:
            off = off * mesh.size(i) + mesh.get_local_rank(i)
    return off * local_len


def _replicated(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _write_cache_mesh(kv_cache, k, v, positions, cache_pos):
    """``_write_cache`` on DTensor caches, in ``local_map`` (DTensor has
    no rule for a write into a slice of a split dim): the cache keeps its
    layout, the new K/V and the positions are brought to it (replicated
    along its sequence dim), and each rank writes the rows it holds."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    ck, cv = kv_cache
    mesh = ck.device_mesh
    cplace = list(ck.placements)
    T_local = ck.to_local().shape[1]
    start = _shard_offset(mesh, cplace, 1, T_local)
    kvp = [Replicate() if p.is_shard() and p.dim == 1 else p for p in cplace]
    posp = [p if p.is_shard() and p.dim == 0 else Replicate()
            for p in cplace]
    write = local_map(
        lambda a, b, kk, vv, pos: _write_rows(a, b, kk, vv, pos, cache_pos,
                                              start, ck.shape[1]),
        out_placements=(cplace, cplace),
        in_placements=(cplace, cplace, kvp, kvp, posp),
        device_mesh=mesh, redistribute_inputs=True)
    return write(ck, cv, k, v, _replicated(positions, mesh))


class _FlashForwardOnly(torch.autograd.Function):
    """The flash kernel (K4) computes the forward only, as the JAX
    package's Pallas kernel does: a backward through it raises, where the
    kernel's output would otherwise carry no gradient to q, k and v."""

    @staticmethod
    def forward(ctx, q, k, v, group: int):
        return kops.attention(q, k, v, causal=True, group=group)

    @staticmethod
    def backward(ctx, grad):
        raise RuntimeError(
            "attn_impl='flash' cannot be differentiated: the flash "
            "attention kernel has no backward (nor has the JAX package's "
            "Pallas kernel); train with attn_impl='einsum'")


def _attention_on_mesh(q) -> bool:
    """Whether attention runs in ``local_map`` (``_attention_mesh``): a
    DTensor ``q`` under active rules."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed import sharding as shd
    return isinstance(q, DTensor) and shd.get_rules() is not None


def _mesh_layout(rules, mesh, B: int, H: int, KV: int, T: int,
                 cached: bool) -> dict:
    """The mesh axes attention runs over: the batch's; the query heads'
    and KV heads' (``model`` where the rules put it and it divides); or,
    for a cache the rules split along its sequence (plans ``heads`` and
    ``replicate``), the cache's sequence dim's, with every query head on
    every rank (flash-decoding: each rank attends to its own rows); or
    head_dim's (plan ``head_dim``: each rank's part of the scores, summed
    over the ranks)."""
    from repro_torch.distributed import sharding as shd
    sizes = shd.axis_sizes(mesh)
    entry = shd.resolve_spec(("batch",), (B,), rules, mesh)
    bax = shd.spec_axes(entry[0] if entry else None)
    tp = sizes.get("model", 1)
    free = "model" in sizes and "model" not in bax

    def takes(dim, size):
        return free and rules.get(dim) == ("model",) and size % tp == 0

    kv = "model" if takes("kv_heads", KV) and takes("heads", H) else None
    seq = "model" if cached and not kv and takes("kv_seq", T) else None
    heads = "model" if takes("heads", H) and not seq else None
    hd = ("model" if not (kv or seq or heads)
          and rules.get("head_dim") == ("model",) and free else None)
    return {"batch": bax, "heads": heads, "kv": kv, "seq": seq,
            "head_dim": hd}


def _attention_mesh(q, k, v, qpos, kpos, scale, scores_dtype,
                    cached: bool):
    """Attention on DTensors in ``local_map`` (DTensor's rules would split
    the grouped query heads and replicate the scores): each rank takes
    its batch rows and query heads, with their KV heads, or its rows of a
    sequence-split cache.  q: (B, S, H, Hd); k/v: (B, T, KV, Hd) → o
    (B, S, H, Hd)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import sharding as shd
    mesh = q.device_mesh
    B, S, H, Hd = q.shape
    T, KV = k.shape[1], k.shape[2]
    lay = _mesh_layout(shd.get_rules(), mesh, B, H, KV, T, cached)
    on_b = {a: 0 for a in lay["batch"]}
    hd = {"model": 3} if lay["head_dim"] else {}
    qp = shd.mesh_placements(mesh, {**on_b, **hd, **({"model": 2}
                                                     if lay["heads"]
                                                     else {})})
    kvp = shd.mesh_placements(mesh, {**on_b, **hd, **(
        {"model": 2} if lay["kv"] else {"model": 1} if lay["seq"] else {})})
    # a rank's query heads read a share of replicated K/V: its gradient
    # there is a part of the sum over the ranks
    kvg = shd.mesh_placements(mesh, {**on_b, **hd, **(
        {"model": 2} if lay["kv"] else {})},
                              ("model",) if lay["heads"] and not lay["kv"]
                              else ())
    posq = shd.mesh_placements(mesh, on_b)
    posk = kvp if lay["seq"] else posq
    midx = mesh.mesh_dim_names.index("model") if "model" in \
        mesh.mesh_dim_names else None
    head0 = (mesh.get_local_rank(midx) * (H // mesh.size(midx))
             if lay["heads"] else 0)
    group = (mesh, midx) if lay["seq"] else None
    score_sum = ((lambda t: _SumOverGroup.apply(t, (mesh, midx)))
                 if lay["head_dim"] else None)
    fn = local_map(
        lambda qq, kk, vv, a, b: _attention_local(
            qq, kk, vv, a, b, scale, scores_dtype, head0, H // KV,
            bool(lay["kv"]), group, score_sum),
        out_placements=qp, in_placements=(qp, kvp, kvp, posq, posk),
        in_grad_placements=(qp, kvg, kvg, posq, posk), device_mesh=mesh,
        redistribute_inputs=True)
    return fn(q, k, v, _replicated(qpos, mesh), _replicated(kpos, mesh))


def _attention_local(q, k, v, qpos, kpos, scale, scores_dtype, head0: int,
                     G: int, kv_split: bool, group, score_sum=None):
    """One rank's attention: q (B, S, Hl, Hd) its query heads from
    ``head0``; k/v its KV heads (``kv_split``) or all of them, and its
    rows of a sequence-split cache over ``group`` (else None); with
    ``score_sum`` its slice of head_dim."""
    B, S, Hl, Hd = q.shape
    if kv_split or (head0 % G == 0 and Hl % G == 0):
        if not kv_split:
            k = k[:, :, head0 // G:(head0 + Hl) // G]
            v = v[:, :, head0 // G:(head0 + Hl) // G]
        qg = q.reshape(B, S, Hl // G, G, Hd)
    else:
        # fewer query heads on a rank than a group: each its own KV head
        idx = (head0 + torch.arange(Hl, device=q.device)) // G
        k, v = k[:, :, idx], v[:, :, idx]
        qg = q.reshape(B, S, Hl, 1, Hd)
    if group is None:
        o = chunked_causal_attention(qg, k, v, qpos, kpos, scale,
                                     scores_dtype=scores_dtype,
                                     score_sum=score_sum)
    else:
        o = _split_rows_attention(qg, k, v, qpos, kpos, scale,
                                  scores_dtype, group)
    return o.reshape(B, S, Hl, Hd)


def _split_rows_attention(q, k, v, qpos, kpos, scale, scores_dtype, group):
    """Attention over a cache whose rows are split over ``group``
    (inference): each rank's scores over its rows, the softmax's max and
    sum and the weighted values summed over the group."""
    from torch.distributed import _functional_collectives as funcol
    B, S = q.shape[:2]
    q_chunk = min(S, ATTN_Q_CHUNK)
    outs = []
    for i in range(0, S, q_chunk):
        qc, qp = q[:, i:i + q_chunk], qpos[:, i:i + q_chunk]
        scores = torch.einsum("bskgh,btkh->bkgst", qc.float(), k.float())
        scores = scores.to(scores_dtype) * scale
        mask = kpos[:, None, None, None, :] <= qp[:, None, None, :, None]
        scores = scores.masked_fill(~mask, torch.finfo(scores_dtype).min / 2)
        m = funcol.all_reduce(scores.amax(-1, keepdim=True), "max", group)
        p = torch.exp((scores - m).float())
        den = funcol.all_reduce(p.sum(-1, keepdim=True), "sum", group)
        o = torch.einsum("bkgst,btkh->bskgh", (p / den).to(v.dtype), v)
        outs.append(funcol.all_reduce(o.float(), "sum", group).to(v.dtype))
    return torch.cat(outs, dim=1)


def multihead_attention(w, x, *, cfg, positions, kv_positions=None,
                        causal=True, kv_cache=None, cache_pos=None,
                        memory=None):
    """Grouped-query attention.

    x: (B, S, D).  With ``kv_cache=(ck, cv)`` of shape (B, T, KV, Hd) the new
    K/V are written at ``cache_pos`` (prefill) or at each row's position
    (decode, S == 1) and attention runs over the cache; the call then
    returns ``(out, (ck, cv))``.  With ``memory`` (B, T, D) keys and values
    come from memory (cross-attention) and neither side gets RoPE;
    ``causal=False`` or ``memory`` masks nothing.  Without a cache, for
    causal self-attention with ``cfg.attn_impl == "flash"`` and
    ``S % 128 == 0``, attention runs in the flash kernel, which masks by
    index, not by ``positions``, and has no backward.
    """
    B, S, D = x.shape
    H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    G = H // KV
    cross = memory is not None

    q = head_proj(x, w.wq)
    src = memory if cross else x
    k = head_proj(src, w.wk, "btd,dkh->btkh")
    v = head_proj(src, w.wv, "btd,dkh->btkh")

    if not cross:
        cos, sin = rope_cos_sin(positions, Hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        if kv_positions is not None:
            cos, sin = rope_cos_sin(kv_positions, Hd, cfg.rope_theta)
        k = apply_rope(k, cos, sin)

    new_cache = None
    if kv_cache is not None:
        k, v = new_cache = _write_cache(kv_cache, k, v, positions, cache_pos)

    if (cfg.attn_impl == "flash" and kv_cache is None and not cross
            and causal and S % 128 == 0):
        # query head (b·KV + kv)·G + g reads kv head b·KV + kv; the kernel
        # takes contiguous tensors (a reshape may return a strided view)
        qf = q.reshape(B, S, KV, G, Hd).permute(0, 2, 3, 1, 4)
        qf = qf.reshape(B * H, S, Hd).contiguous()
        kf = k.permute(0, 2, 1, 3).reshape(B * KV, S, Hd).contiguous()
        vf = v.permute(0, 2, 1, 3).reshape(B * KV, S, Hd).contiguous()
        o = _FlashForwardOnly.apply(qf, kf, vf, G)
        o = o.reshape(B, H, S, Hd).permute(0, 2, 1, 3)
        return torch.einsum("bshk,hkd->bsd", o.to(x.dtype), w.wo)

    T = k.shape[1]
    scale = 1.0 / float(Hd) ** 0.5
    if kv_cache is not None:
        kpos = torch.arange(T, dtype=torch.int32, device=x.device)
        kpos, qpos = kpos[None].expand(B, T), positions
    elif causal and not cross:
        kpos, qpos = positions, positions
    else:
        # bidirectional / cross: kpos = 0 <= qpos makes the mask all-true
        kpos = torch.zeros((B, T), dtype=torch.int32, device=x.device)
        qpos = positions.clamp(min=0)
    sdt = getattr(torch, cfg.attn_scores_dtype)
    if _attention_on_mesh(q):
        o = _attention_mesh(q, k, v, qpos, kpos, scale, sdt,
                            cached=kv_cache is not None)
    else:
        o = chunked_causal_attention(q.reshape(B, S, KV, G, Hd), k, v,
                                     qpos, kpos, scale, scores_dtype=sdt)
    o = o.reshape(B, S, H, Hd)
    out = head_unproj(o, w.wo)
    return (out, new_cache) if kv_cache is not None else out


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def swiglu_defs(cfg, n_layers=None, d_ff=None):
    D = cfg.d_model
    F_ = d_ff or cfg.d_ff
    L = (n_layers,) if n_layers is not None else ()
    pd = ("layers",) if n_layers is not None else ()
    return {
        "w1": ParamDef(L + (D, F_), pd + ("embed", "mlp")),
        "w3": ParamDef(L + (D, F_), pd + ("embed", "mlp")),
        "w2": ParamDef(L + (F_, D), pd + ("mlp", "embed")),
    }


def swiglu(w, x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    if isinstance(w.w1, DTensor):
        return _swiglu_mesh(w, x)
    h = F.silu(x @ w.w1)
    h = h * (x @ w.w3)
    return h @ w.w2


def _swiglu_mesh(w, x):
    """SwiGLU on DTensors in ``local_map``, Megatron's MLP: w1/w3 split
    along their output (``mlp``) and w2 along its input as the rules lay
    them, each rank its batch rows, the output a ``Partial`` sum over the
    ranks of the split (DTensor's rules can leave a layer's weight
    gradient whole on every rank)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.w1.device_mesh
    x = _replicated(x, mesh)
    xp = _batch_placements(x)
    split = [p.is_shard() and p.dim == 1 for p in w.w1.placements]
    w13 = [Shard(1) if s_ else Replicate() for s_ in split]
    w2p = [Shard(0) if s_ else Replicate() for s_ in split]
    out = [Partial() if s_ else p for s_, p in zip(split, xp)]

    def wgrad(pl):
        return [Partial() if p.is_shard() else q for p, q in zip(xp, pl)]

    def local(a, w1, w3, w2):
        return (F.silu(a @ w1) * (a @ w3)) @ w2

    return local_map(local, out_placements=out,
                     in_placements=(xp, w13, w13, w2p),
                     in_grad_placements=(out, wgrad(w13), wgrad(w13),
                                         wgrad(w2p)),
                     device_mesh=mesh, redistribute_inputs=True)(
        x, w.w1, w.w3, w.w2)


class SwiGLU(nn.Module):
    def __init__(self, tree):
        super().__init__()
        for name in ("w1", "w3", "w2"):
            setattr(self, name, _param(tree[name]))

    def forward(self, x):
        return swiglu(self, x)


# ---------------------------------------------------------------------------
# Embedding / head / loss
# ---------------------------------------------------------------------------

def embed_lookup(tok: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of the embedding ``tok`` (V, D).  A DTensor table
    is read in ``local_map`` (DTensor's rule for the lookup's backward,
    an accumulating ``index_put``, does not hold across versions): each
    rank its batch rows, and from a table split along the vocab only the
    tokens in its slice, the rows summed over the ranks (Megatron's
    vocab-parallel embedding)."""
    from torch.distributed.tensor import DTensor, Replicate
    if not isinstance(tok, DTensor):
        return tok[tokens.long()]
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import sharding as shd
    mesh = tok.device_mesh
    tp = list(tok.placements)
    tokens = _replicated(tokens, mesh)
    names = mesh.mesh_dim_names
    bp = [p if p.is_shard() and p.dim == 0 else Replicate()
          for p in tokens.placements]
    batch = {names[i]: 0 for i, p in enumerate(bp) if p.is_shard()}
    if any(p.is_shard() and p.dim == 1 for p in tp):
        raise ValueError("an embedding split along its width: gather it "
                         "first (sharding.for_use)")
    vocab = [names[i] for i, p in enumerate(tp) if p.is_shard()]
    V_local = tok.to_local().shape[0]
    off = _shard_offset(mesh, tp, 0, V_local)

    def lookup(t, ids):
        if not vocab:
            return t[ids.long()]
        idx = ids.long() - off
        mine = ((idx >= 0) & (idx < V_local))[..., None]
        rows = t[idx.clamp(0, V_local - 1)]
        return torch.where(mine, rows, torch.zeros_like(rows))

    return local_map(
        lookup, out_placements=shd.mesh_placements(mesh, batch, vocab),
        in_placements=(tp, bp),
        in_grad_placements=(shd.mesh_placements(
            mesh, {a: 0 for a in vocab}, tuple(batch)), bp),
        device_mesh=mesh, redistribute_inputs=True)(tok, tokens)


def embed_defs(cfg):
    return {
        "tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
    }


def head_defs(cfg):
    if cfg.tie_embeddings:
        return {}
    return {"out": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"))}


def logits_from(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """``params`` holds ``tok`` (V, D) and, untied, ``out`` (D, V).  On
    DTensors the head is a column-parallel product in ``local_map``: each
    rank its batch rows against its slice of the vocab."""
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import for_use
    w = for_use(params.tok).t() if cfg.tie_embeddings else for_use(params.out)
    if not isinstance(w, DTensor):
        return x @ w
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    mesh = w.device_mesh
    x = _replicated(x, mesh)
    xp = _batch_placements(x)
    wp = [Shard(1) if p.is_shard() and p.dim == 1 else Replicate()
          for p in w.placements]
    out = [Shard(2) if q.is_shard() else p for p, q in zip(xp, wp)]
    return local_map(
        lambda a, b: a @ b, out_placements=out, in_placements=(xp, wp),
        in_grad_placements=([Partial() if q.is_shard() else p
                             for p, q in zip(xp, wp)],
                            [Partial() if p.is_shard() else q
                             for p, q in zip(xp, wp)]),
        device_mesh=mesh, redistribute_inputs=True)(x, w)


class _SumOverGroup(torch.autograd.Function):
    """All-reduce (sum) of a rank's part of a value every rank then uses
    whole: the gradient of each part is the whole's gradient."""

    @staticmethod
    def forward(ctx, t, group):
        from torch.distributed import _functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(t, "sum", group))

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def _token_log_likelihood_mesh(logits, labels):
    """``log_softmax(logits)[label]`` of DTensor logits, in ``local_map``
    (DTensor's rules would gather the logits whole, and its ``gather``
    backward makes a replicated zero tensor of the logits' global shape).
    Logits split along the vocab take Megatron's vocab-parallel form:
    each rank's max, exp-sum and label pick over its slice of the vocab,
    reduced over the ranks that split it; unsplit, each rank takes the
    plain ``log_softmax`` and ``gather`` of its rows."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = logits.device_mesh
    xp = list(logits.placements)
    vdim = logits.dim() - 1
    V_local = logits.to_local().shape[-1]
    off = _shard_offset(mesh, xp, vdim, V_local)
    vocab_dims = [i for i, p in enumerate(xp) if p.is_shard()
                  and p.dim == vdim]
    if len(vocab_dims) > 1:
        raise ValueError(f"logits split along the vocab over mesh dims "
                         f"{vocab_dims}: one is supported")
    group = (mesh, vocab_dims[0]) if vocab_dims else None
    lp = [p if p.is_shard() and p.dim == 0 else Replicate() for p in xp]

    def local(xl, ll):
        x = xl.float()
        if group is None:
            lsm = torch.log_softmax(x, dim=-1)
            return lsm.gather(-1, ll[..., None].long())[..., 0]
        with torch.no_grad():
            m = funcol.wait_tensor(funcol.all_reduce(
                x.amax(-1, keepdim=True), "max", group))
        den = _SumOverGroup.apply(torch.exp(x - m).sum(-1), group)
        idx = ll.long() - off
        mine = (idx >= 0) & (idx < V_local)
        got = x.gather(-1, idx.clamp(0, V_local - 1)[..., None])[..., 0]
        got = _SumOverGroup.apply(torch.where(mine, got, torch.zeros_like(
            got)), group)
        return got - (torch.log(den) + m[..., 0])

    return local_map(local, out_placements=lp, in_placements=(xp, lp),
                     device_mesh=mesh, redistribute_inputs=True)(
        logits, _replicated(labels, mesh))


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (optionally masked) positions; logits in float32
    (DTensors: ``_token_log_likelihood_mesh``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(logits, DTensor):
        ll = _token_log_likelihood_mesh(logits, labels)
    else:
        lp = torch.log_softmax(logits.float(), dim=-1)
        ll = lp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)
