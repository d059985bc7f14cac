"""Decoder stack of the dense LM family: the port of the JAX package's
``models/transformer.py`` (``family == "dense"``).

One code path serves scoring, prefill and decode:

* ``forward(params, batch, cfg, cache=None)`` runs the block stack.  With
  ``cache`` it both reads (attention over the cached K/V) and writes (the
  cache's tensors are updated in place, and the returned cache holds them
  with the new ``pos``).  Prefill is the S > 1 case with a fresh cache;
  decode is S == 1.
* The layers are an ``nn.ModuleList`` run by a Python loop.  The
  reference's ``scan_layers`` and ``remat`` are JAX lowering knobs with no
  effect on what the loop computes.

The parameters are a ``DenseLM`` module built from a parameter tree of the
JAX package's structure: stacked ``(L, ...)`` leaves are split per layer
into views, so no weight is copied.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn

from repro_torch.models.layers import (Attention, SwiGLU, _param,
                                       attention_defs, cross_entropy,
                                       embed_defs, head_defs, logits_from,
                                       rms_norm, swiglu_defs)
from repro_torch.models.params import ParamDef, torch_dtype


class TensorSpec(NamedTuple):
    """Shape and dtype of a tensor not made yet (``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype


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


def layer_tree(layers, i: int):
    """Layer ``i``'s tree from either list-form or stacked layers."""
    if isinstance(layers, (list, tuple)):
        return layers[i]
    if isinstance(layers, dict):
        return {k: layer_tree(v, i) for k, v in layers.items()}
    return layers[i]


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class DenseBlock(nn.Module):
    """GQA + RoPE attention and a SwiGLU FFN, each behind an RMSNorm."""

    def __init__(self, tree):
        super().__init__()
        self.ln1 = _param(tree["ln1"])
        self.ln2 = _param(tree["ln2"])
        self.attn = Attention(tree["attn"])
        self.mlp = SwiGLU(tree["mlp"])

    def forward(self, x, cfg, positions, cache_kv=None, cache_pos=None):
        """→ (x, new K/V pair or None)."""
        x, new_kv = _attn_block(self, x, cfg, positions, cache_kv, cache_pos)
        h = rms_norm(x, self.ln2, cfg.norm_eps)
        return x + self.mlp(h), new_kv


class DenseLM(nn.Module):
    """The weights of a dense decoder-only LM, in the JAX layouts, from a
    parameter tree of the JAX package's structure."""

    def __init__(self, tree, cfg):
        super().__init__()
        _require_dense(cfg)
        self.tok = _param(tree["embed"]["tok"])
        self.layers = nn.ModuleList(
            DenseBlock(layer_tree(tree["layers"], i))
            for i in range(cfg.n_layers))
        self.ln_f = _param(tree["ln_f"])
        out = tree["head"].get("out")
        self.out = None if out is None else _param(out)


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
        a, new_kv = w.attn(h, cfg=cfg, positions=positions,
                           kv_cache=cache_kv, cache_pos=cache_pos)
    else:
        a = w.attn(h, cfg=cfg, positions=positions)
        new_kv = None
    return x + a, new_kv


def _run_attn_family(params: DenseLM, x, cfg, positions, cache):
    for i, block in enumerate(params.layers):
        ckv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        x, _ = block(x, cfg, positions, ckv,
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
