"""Transformer building blocks: the port of the JAX package's
``models/layers.py``.

The math is plain functions on tensors, taking any object with the
weights as attributes; the weights live in small ``nn.Module``s
(``Attention``, ``SwiGLU``) whose parameters keep the JAX layouts (``wq``
``(D, H, Hd)``, ``wo`` ``(H, Hd, D)``, ...), so that a JAX parameter tree
maps onto them as a copy.  Attention uses the grouped
formulation: queries reshaped to ``(B, S, KV, G, Hd)``, so K/V are never
repeated.

The reference's ``constrain`` sharding calls are dropped: without a mesh
they are no-ops, and this port runs on one card.  ``multihead_attention``
keeps every path of the reference: causal self-attention (cache-less,
decode and prefill through a cache, and the flash kernel), bidirectional
self-attention (``causal=False``, the encoder's) and cross-attention
(``memory``, no RoPE on either side), and ``kv_positions``.

A KV cache is written in place (JAX returns new arrays): ``kv_cache``'s
tensors hold the new K/V after the call, and the returned pair is them.
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


class Attention(nn.Module):
    """Grouped-query attention weights, in the JAX layouts."""

    def __init__(self, tree):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo"):
            setattr(self, name, _param(tree[name]))


# default query chunk: bounds the live (Qc, T) score block
ATTN_Q_CHUNK = 1024


def _attn_one_chunk(qc, k, v, qpos_c, kpos, scale,
                    scores_dtype=torch.float32):
    """qc: (B,Qc,KV,G,Hd); k/v: (B,T,KV,Hd); positions → out (B,Qc,KV,G,Hd).

    The scores are the float32 product (the reference's
    ``preferred_element_type``) in ``scores_dtype``; the probabilities are
    cast to ``v``'s dtype before the PV product, as in the reference."""
    scores = torch.einsum("bskgh,btkh->bkgst", qc.float(), k.float())
    scores = scores.to(scores_dtype) * scale
    mask = kpos[:, None, None, None, :] <= qpos_c[:, None, None, :, None]
    neg = torch.finfo(scores_dtype).min / 2
    scores = scores.masked_fill(~mask, neg)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgst,btkh->bskgh", probs, v)


def chunked_causal_attention(q, k, v, qpos, kpos, scale, q_chunk=ATTN_Q_CHUNK,
                             scores_dtype=torch.float32):
    """Exact causal attention without materialising the full (S, T) score
    matrix: a loop over query chunks, so only a (Qc, T) block is live."""
    B, S, KV, G, Hd = q.shape
    if S <= q_chunk:
        return _attn_one_chunk(q, k, v, qpos, kpos, scale, scores_dtype)
    if S % q_chunk:
        raise ValueError(f"S={S} must be a multiple of q_chunk={q_chunk}")
    outs = [_attn_one_chunk(q[:, i:i + q_chunk], k, v, qpos[:, i:i + q_chunk],
                            kpos, scale, scores_dtype)
            for i in range(0, S, q_chunk)]
    return torch.cat(outs, dim=1)


def _write_cache(kv_cache: KVCache, k, v, positions, cache_pos) -> KVCache:
    ck, cv = kv_cache
    B, S = k.shape[:2]
    if S == 1:
        # decode: per-slot write positions (continuous batching)
        rows = torch.arange(B, device=k.device)
        cols = positions[:, 0].long()
        ck[rows, cols] = k[:, 0].to(ck.dtype)
        cv[rows, cols] = v[:, 0].to(cv.dtype)
    else:
        # prefill: contiguous block write at cache_pos, the start clamped
        # so the block fits, as dynamic_update_slice clamps it
        start = min(max(int(cache_pos), 0), ck.shape[1] - S)
        ck[:, start:start + S] = k.to(ck.dtype)
        cv[:, start:start + S] = v.to(cv.dtype)
    return ck, cv


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

    q = torch.einsum("bsd,dhk->bshk", x, w.wq)
    src = memory if cross else x
    k = torch.einsum("btd,dkh->btkh", src, w.wk)
    v = torch.einsum("btd,dkh->btkh", src, w.wv)

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

    q = q.reshape(B, S, KV, G, Hd)
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
    o = chunked_causal_attention(
        q, k, v, qpos, kpos, scale,
        scores_dtype=getattr(torch, cfg.attn_scores_dtype))
    o = o.reshape(B, S, H, Hd)
    out = torch.einsum("bshk,hkd->bsd", o, w.wo)
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
    h = F.silu(x @ w.w1)
    h = h * (x @ w.w3)
    return h @ w.w2


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

def embed_defs(cfg):
    return {
        "tok": ParamDef((cfg.vocab, cfg.d_model), ("vocab", "embed"), scale=0.02),
    }


def head_defs(cfg):
    if cfg.tie_embeddings:
        return {}
    return {"out": ParamDef((cfg.d_model, cfg.vocab), ("embed", "vocab"))}


def logits_from(params, x: torch.Tensor, cfg) -> torch.Tensor:
    """``params`` holds ``tok`` (V, D) and, untied, ``out`` (D, V)."""
    if cfg.tie_embeddings:
        return x @ params.tok.t()
    return x @ params.out


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over (optionally masked) positions; logits in float32."""
    lp = torch.log_softmax(logits.float(), dim=-1)
    ll = lp.gather(-1, labels[..., None].long())[..., 0]
    if mask is None:
        return -ll.mean()
    mask = mask.float()
    return -(ll * mask).sum() / mask.sum().clamp(min=1.0)
