"""Decoder stack of the dense LM family: the port of the JAX package's
``models/transformer.py`` (``family == "dense"``).

One code path serves training, scoring, prefill and decode:

* ``forward(params, batch, cfg, cache=None)`` runs the block stack.  With
  ``cache`` it both reads (attention over the cached K/V) and writes (the
  cache's tensors are updated in place, and the returned cache holds them
  with the new ``pos``).  Prefill is the S > 1 case with a fresh cache;
  decode is S == 1.
* The layers run in a Python loop.  Under autograd with ``cfg.remat``,
  each block runs under ``torch.utils.checkpoint`` (non-reentrant), as
  the reference's ``jax.remat`` of the scan body: ``remat_policy``
  ``"nothing"`` (or ``"none"``) keeps only the block's input, ``"dots"``
  also the outputs of the products without batch dims (the weight
  matmuls), as ``checkpoint_dots_with_no_batch_dims``.

The parameters are a ``DenseLM`` module holding the JAX package's tree:
with ``cfg.scan_layers`` each layer leaf is one stacked ``(L, ...)``
parameter, else a list of per-layer blocks.  ``DenseLM.tree()`` gives the
tree back (the optimizer's and the checkpoint's leaves, in jax's order),
and ``DenseLM.layers`` each layer's weights: views of the stacked leaves,
made by one ``unbind`` each, so a layer's gradient lands in its slice of
the stacked leaf's gradient, as the reference's scan writes it.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.models.layers import (Attention, SwiGLU, _param,
                                       attention_defs, cross_entropy,
                                       embed_defs, head_defs, logits_from,
                                       multihead_attention, rms_norm, swiglu,
                                       swiglu_defs)
from repro_torch.models.params import ParamDef, TensorSpec, torch_dtype


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _norm_def(cfg, L=None, dim=None):
    d = dim or cfg.d_model
    if L is None:
        return ParamDef((d,), ("embed",), init="ones")
    return ParamDef((L, d), ("layers", "embed"), init="ones")


def _require_dense(cfg) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet: the port runs the "
            "dense LMs; moe, vlm, hybrid, ssm and encdec are queued in "
            "ROADMAP A7(b)")


def stack_defs(cfg) -> Dict[str, Any]:
    """Parameter-definition tree of a dense decoder, the reference's tree:
    layers stacked on a leading L dim (``cfg.scan_layers``) or a list of
    per-layer trees."""
    _require_dense(cfg)
    L = cfg.n_layers

    def one_layer(Ln):
        return {"ln1": _norm_def(cfg, Ln), "ln2": _norm_def(cfg, Ln),
                "attn": attention_defs(cfg, n_layers=Ln),
                "mlp": swiglu_defs(cfg, n_layers=Ln)}

    return {"embed": embed_defs(cfg),
            "layers": (one_layer(L) if cfg.scan_layers
                       else [one_layer(None) for _ in range(L)]),
            "ln_f": _norm_def(cfg),
            "head": head_defs(cfg)}


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

_ATTN, _MLP = ("wk", "wo", "wq", "wv"), ("w1", "w2", "w3")


class DenseBlock(nn.Module):
    """The weights of GQA + RoPE attention and a SwiGLU FFN, each behind
    an RMSNorm: one layer's, or every layer's stacked on a leading L dim."""

    def __init__(self, tree):
        super().__init__()
        self.ln1 = _param(tree["ln1"])
        self.ln2 = _param(tree["ln2"])
        self.attn = Attention(tree["attn"])
        self.mlp = SwiGLU(tree["mlp"])

    def tree(self) -> Dict[str, Any]:
        return {"attn": {n: getattr(self.attn, n) for n in _ATTN},
                "ln1": self.ln1, "ln2": self.ln2,
                "mlp": {n: getattr(self.mlp, n) for n in _MLP}}


def _layer_views(stack: DenseBlock) -> list:
    """Each layer's weights as views of the stacked leaves."""
    t = stack.tree()
    attn = {n: t["attn"][n].unbind(0) for n in _ATTN}
    mlp = {n: t["mlp"][n].unbind(0) for n in _MLP}
    ln1, ln2 = t["ln1"].unbind(0), t["ln2"].unbind(0)
    return [SimpleNamespace(
        ln1=ln1[i], ln2=ln2[i],
        attn=SimpleNamespace(**{n: attn[n][i] for n in _ATTN}),
        mlp=SimpleNamespace(**{n: mlp[n][i] for n in _MLP}))
        for i in range(len(ln1))]


class DenseLM(nn.Module):
    """The weights of a dense decoder-only LM, in the JAX layouts, from a
    parameter tree of the JAX package's structure (no weight copied)."""

    def __init__(self, tree, cfg):
        super().__init__()
        _require_dense(cfg)
        self.cfg = cfg
        self.tok = _param(tree["embed"]["tok"])
        layers = tree["layers"]
        if isinstance(layers, dict):
            self.stack = DenseBlock(layers)
        else:
            self.blocks = nn.ModuleList(DenseBlock(t) for t in layers)
        self.ln_f = _param(tree["ln_f"])
        out = tree["head"].get("out")
        self.out = None if out is None else _param(out)

    @property
    def layers(self) -> list:
        """Each layer's weights (``ln1``, ``ln2``, ``attn.wq``, ...)."""
        if hasattr(self, "stack"):
            return _layer_views(self.stack)
        return list(self.blocks)

    def tree(self) -> Dict[str, Any]:
        """The parameters in the JAX package's tree."""
        layers = (self.stack.tree() if hasattr(self, "stack")
                  else [b.tree() for b in self.blocks])
        return {"embed": {"tok": self.tok},
                "head": {} if self.out is None else {"out": self.out},
                "layers": layers, "ln_f": self.ln_f}


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of the KV cache; :func:`init_cache` makes it.
    ``pos``, the reference's int32 scalar, is a host int in the port."""
    _require_dense(cfg)
    dt = torch_dtype(cfg.dtype)
    KV, Hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    return {"k": TensorSpec((L, batch, max_len, KV, Hd), dt),
            "v": TensorSpec((L, batch, max_len, KV, Hd), dt),
            "pos": TensorSpec((), torch.int32)}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    spec = cache_spec(cfg, batch, max_len)
    return {"k": torch.zeros(spec["k"].shape, dtype=spec["k"].dtype,
                             device=device),
            "v": torch.zeros(spec["v"].shape, dtype=spec["v"].dtype,
                             device=device),
            "pos": 0}


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attn_block(w, x, cfg, positions, cache_kv=None, cache_pos=None):
    h = rms_norm(x, w.ln1, cfg.norm_eps)
    if cache_kv is not None:
        a, new_kv = multihead_attention(w.attn, h, cfg=cfg,
                                        positions=positions,
                                        kv_cache=cache_kv,
                                        cache_pos=cache_pos)
    else:
        a = multihead_attention(w.attn, h, cfg=cfg, positions=positions)
        new_kv = None
    return x + a, new_kv


def dense_block(w, x, cfg, positions, cache_kv=None, cache_pos=None):
    """One block on the layer weights ``w`` → (x, new K/V pair or None)."""
    x, new_kv = _attn_block(w, x, cfg, positions, cache_kv, cache_pos)
    h = rms_norm(x, w.ln2, cfg.norm_eps)
    return x + swiglu(w.mlp, h), new_kv


def _dots_policy(ctx, op, *args, **kwargs):
    """Save the products without batch dims: the weight matmuls (``x @
    w``, and the einsums against a weight, which run as a ``bmm`` of
    batch 1); recompute the rest."""
    aten = torch.ops.aten
    keep = op in (aten.mm.default, aten.addmm.default) or (
        op is aten.bmm.default and args[0].shape[0] == 1)
    return (ckpt.CheckpointPolicy.MUST_SAVE if keep
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat_block(w, x, cfg, positions):
    """``dense_block`` under ``torch.utils.checkpoint``: its activations
    are recomputed in the backward, as ``jax.remat`` recomputes them."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(lambda h: dense_block(w, h, cfg, positions)[0],
                           x, use_reentrant=False, **kw)


def _run_attn_family(params: DenseLM, x, cfg, positions, cache):
    remat = (cfg.remat and cache is None and torch.is_grad_enabled()
             and any(p.requires_grad for p in params.parameters()))
    for i, w in enumerate(params.layers):
        if remat:
            x = _remat_block(w, x, cfg, positions)
            continue
        ckv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        x, _ = dense_block(w, x, cfg, positions, ckv,
                           cache["pos"] if cache is not None else None)
    if cache is None:
        return x, 0.0, None
    return x, 0.0, dict(cache, pos=cache["pos"] + x.shape[1])


# ---------------------------------------------------------------------------
# Public forward
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: Any
    cache: Optional[Dict[str, Any]]


def forward(params: DenseLM, batch: Dict[str, torch.Tensor], cfg,
            cache=None) -> ForwardOut:
    """batch: {'tokens': (B, S) int, optional 'positions': (B, S)}."""
    _require_dense(cfg)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = params.tok[tokens.long()].to(torch_dtype(cfg.dtype))

    positions = batch.get("positions")
    if positions is None:
        start = cache["pos"] if cache is not None else 0
        positions = start + torch.arange(S, dtype=torch.int32,
                                         device=tokens.device)
        positions = positions[None].expand(B, S)

    x, aux, cache = _run_attn_family(params, x, cfg, positions, cache)
    x = rms_norm(x, params.ln_f, cfg.norm_eps)
    return ForwardOut(logits_from(params, x, cfg), aux, cache)


def loss_from_logits(logits: torch.Tensor, batch, cfg) -> torch.Tensor:
    """Next-token CE of ``forward``'s logits, as ``lm_loss`` takes it."""
    _require_dense(cfg)
    return cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         batch.get("loss_mask"))


def lm_loss(params: DenseLM, batch, cfg) -> torch.Tensor:
    return loss_from_logits(forward(params, batch, cfg).logits, batch, cfg)
