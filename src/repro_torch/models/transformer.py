"""Decoder stacks of every LM family: the port of the JAX package's
``models/transformer.py``.

One code path serves training, scoring, prefill and decode:

* ``forward(params, batch, cfg, cache=None)`` runs the block stack.  With
  ``cache`` it both reads (attention over the cached K/V, the SSM and WKV
  states) and writes: attention K/V are written into the cache's tensors
  in place, the recurrent states come back as new tensors, and the
  returned cache holds both with the new ``pos``.  Prefill is the S > 1
  case with a fresh cache; decode is S == 1.
* The layers run in a Python loop.  Under autograd with ``cfg.remat``,
  each block (attention, RWKV, Mamba, the hybrid's shared attention;
  encdec's encoder and decoder blocks too) runs under
  ``torch.utils.checkpoint`` (non-reentrant, ``remat_block``), as the
  reference's ``jax.remat`` of the scan body: ``remat_policy``
  ``"nothing"`` (or ``"none"``) keeps only the block's input, ``"dots"``
  also the outputs of the products without batch dims (the weight
  matmuls), as ``checkpoint_dots_with_no_batch_dims``.

Block families: ``dense`` (GQA + RoPE + SwiGLU), ``moe`` (GQA + MoE FFN),
``ssm`` (RWKV6 blocks), ``hybrid`` (Mamba2 backbone + a weight-shared
attention block before every ``cfg.hybrid.attn_every`` layers,
zamba2-style), ``vlm`` (dense backbone over [patch embeds | text]).
Encoder-decoder lives in ``encdec.py``.

The parameters are an ``LM`` module holding the JAX package's tree: with
``cfg.scan_layers`` each layer leaf is one stacked ``(L, ...)``
parameter, else a list of per-layer trees.  ``LM.tree()`` gives the tree
back (the optimizer's and the checkpoint's leaves, in jax's order), and
``LM.views(key)`` each layer's weights: views of the stacked leaves, made
by one ``unbind`` each, so a layer's gradient lands in its slice of the
stacked leaf's gradient, as the reference's scan writes it.  ``DenseLM``
is the same class, under the name the dense slices gave it.

Under a mesh (``mesh=`` a ``DeviceMesh``, the weights DTensors) the
reference's sharding constraints are kept where it has them: the
embedding's output and each block's output are ``constrain``ed to
``("batch", "seq", "embed")`` (and, beyond the reference, the residual
after each attention or time mix, where XLA's propagation reduces the
heads' partial sum and DTensor would carry it into the MLP), and each
block re-asserts its layer's
weight placements (``constrain_layer_weights``) inside the block, so
that remat gathers a layer's weights again in the backward instead of
holding every layer's gathered weights.
"""
from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any, Dict, NamedTuple, Optional

import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch.distributed.sharding import constrain, for_use, get_mesh
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv as rwkv_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (_param, attention_defs, cross_entropy,
                                       embed_defs, embed_lookup, head_defs,
                                       logits_from, multihead_attention,
                                       rms_norm, swiglu, swiglu_defs)
from repro_torch.models.params import ParamDef, TensorSpec, torch_dtype

#: the families that ``stack_defs`` and ``forward`` run (encdec has its own
#: module)
ATTN_FAMILIES = ("dense", "vlm", "moe")


# ---------------------------------------------------------------------------
# Parameter definitions
# ---------------------------------------------------------------------------

def _norm_def(cfg, L=None, dim=None):
    d = dim or cfg.d_model
    if L is None:
        return ParamDef((d,), ("embed",), init="ones")
    return ParamDef((L, d), ("layers", "embed"), init="ones")


def stack_defs(cfg) -> Dict[str, Any]:
    """Parameter-definition tree of a decoder-only model, the reference's
    tree: layers stacked on a leading L dim (``cfg.scan_layers``) or a
    list of per-layer trees."""
    L = cfg.n_layers
    stacked = cfg.scan_layers

    def one_layer(Ln):
        if cfg.family in ATTN_FAMILIES:
            layer = {"ln1": _norm_def(cfg, Ln), "ln2": _norm_def(cfg, Ln),
                     "attn": attention_defs(cfg, n_layers=Ln)}
            if cfg.family == "moe":
                layer["moe"] = moe_mod.moe_defs(cfg, n_layers=Ln,
                                                stacked=stacked)
            else:
                layer["mlp"] = swiglu_defs(cfg, n_layers=Ln)
            return layer
        if cfg.family == "ssm":
            return {"ln1": _norm_def(cfg, Ln), "ln2": _norm_def(cfg, Ln),
                    "rwkv": rwkv_mod.rwkv_defs(cfg, n_layers=Ln)}
        if cfg.family == "hybrid":
            return {"ln": _norm_def(cfg, Ln),
                    "mamba": ssm_mod.mamba_defs(cfg, n_layers=Ln)}
        raise ValueError(cfg.family)

    defs: Dict[str, Any] = {"embed": embed_defs(cfg)}
    defs["layers"] = (one_layer(L) if stacked
                      else [one_layer(None) for _ in range(L)])
    if cfg.family == "vlm":
        defs["patch_proj"] = ParamDef(
            (cfg.vlm.patch_dim, cfg.d_model), ("patch_dim", "embed"))
    if cfg.family == "ssm":
        defs["ln_in"] = _norm_def(cfg)
    if cfg.family == "hybrid":
        defs["shared"] = {"ln1": _norm_def(cfg), "ln2": _norm_def(cfg),
                          "attn": attention_defs(cfg),
                          "mlp": swiglu_defs(cfg)}
    defs["ln_f"] = _norm_def(cfg)
    defs["head"] = head_defs(cfg)
    return defs


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

class _Tree(nn.Module):
    """One dict of a parameter tree: each key an attribute (a parameter,
    a ``_Tree``, or a list: ``nn.ModuleList`` of trees, ``nn.ParameterList``
    of tensors)."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        self._keys = sorted(tree)
        for k in self._keys:
            v = tree[k]
            if isinstance(v, dict):
                setattr(self, k, _Tree(v))
            elif isinstance(v, (list, tuple)):
                setattr(self, k, nn.ModuleList(_Tree(t) for t in v)
                        if v and isinstance(v[0], dict)
                        else nn.ParameterList(_param(t) for t in v))
            else:
                setattr(self, k, _param(v))

    def tree(self) -> Dict[str, Any]:
        return {k: _subtree(getattr(self, k)) for k in self._keys}


def _subtree(node):
    if isinstance(node, _Tree):
        return node.tree()
    if isinstance(node, nn.ModuleList):
        return [m.tree() for m in node]
    if isinstance(node, nn.ParameterList):
        return list(node)
    return node


def _unbind(node) -> list:
    """A stacked ``_Tree`` → one namespace of views per leading index."""
    if not isinstance(node, _Tree):
        return node.unbind(0)
    parts = {k: _unbind(getattr(node, k)) for k in node._keys}
    n = len(next(iter(parts.values())))
    return [SimpleNamespace(**{k: v[i] for k, v in parts.items()})
            for i in range(n)]


class LM(nn.Module):
    """The weights of an LM of any family, in the JAX layouts, from a
    parameter tree of the JAX package's structure (no weight copied).
    ``p`` holds the tree's top-level keys as attributes (``p.embed.tok``,
    ``p.shared.attn.wq``, ...)."""

    def __init__(self, tree, cfg):
        super().__init__()
        self.cfg = cfg
        self.p = _Tree(tree)

    def tree(self) -> Dict[str, Any]:
        """The parameters in the JAX package's tree."""
        return self.p.tree()

    def views(self, key: str = "layers") -> list:
        """Each layer's weights of the stack under ``key`` (``layers``,
        or encdec's ``encoder`` / ``decoder``): views of the stacked
        leaves, or the list form's own per-layer trees."""
        node = getattr(self.p, key)
        if isinstance(node, nn.ModuleList):
            return list(node)
        return _unbind(node)

    @property
    def layers(self) -> list:
        """Each layer's weights (``ln1``, ``ln2``, ``attn.wq``, ...)."""
        return self.views("layers")

    @property
    def tok(self) -> torch.Tensor:
        return self.p.embed.tok

    @property
    def out(self) -> Optional[torch.Tensor]:
        """The untied head ``(D, V)``; None with tied embeddings."""
        return getattr(self.p.head, "out", None)

    @property
    def ln_f(self) -> torch.Tensor:
        return self.p.ln_f


#: the dense slices' name for ``LM`` (training, checkpoints and convert
#: take either)
DenseLM = LM


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

def _n_attn_apps(cfg) -> int:
    ae = cfg.hybrid.attn_every
    return (cfg.n_layers + ae - 1) // ae


def cache_spec(cfg, batch: int, max_len: int) -> Dict[str, TensorSpec]:
    """Shapes and dtypes of the cache; :func:`init_cache` makes it.
    ``pos``, the reference's int32 scalar, is a host int in the port."""
    dt = torch_dtype(cfg.dtype)
    f32 = torch.float32
    KV, Hd, L = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    S = TensorSpec
    pos = S((), torch.int32)
    if cfg.family in ATTN_FAMILIES:
        return {"k": S((L, batch, max_len, KV, Hd), dt),
                "v": S((L, batch, max_len, KV, Hd), dt), "pos": pos}
    if cfg.family == "ssm":
        H, K = rwkv_mod.rwkv_dims(cfg)
        return {"wkv": S((L, batch, H, K, K), f32),
                "shift_tm": S((L, batch, cfg.d_model), dt),
                "shift_cm": S((L, batch, cfg.d_model), dt), "pos": pos}
    if cfg.family == "hybrid":
        d_in, H, Pd, N = ssm_mod.ssm_dims(cfg)
        napp, dc = _n_attn_apps(cfg), cfg.ssm.d_conv
        return {"state": S((L, batch, H, Pd, N), f32),
                "conv_x": S((L, batch, dc - 1, d_in), dt),
                "conv_b": S((L, batch, dc - 1, N), dt),
                "conv_c": S((L, batch, dc - 1, N), dt),
                "attn_k": S((napp, batch, max_len, KV, Hd), dt),
                "attn_v": S((napp, batch, max_len, KV, Hd), dt),
                "pos": pos}
    raise ValueError(cfg.family)


CACHE_DIMS = {
    "k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "attn_k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "attn_v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
    "wkv": ("layers", "batch", "heads", "head_dim", None),
    "shift_tm": ("layers", "batch", "embed"),
    "shift_cm": ("layers", "batch", "embed"),
    "state": ("layers", "batch", "heads", "head_dim", "ssm_state"),
    "conv_x": ("layers", "batch", "conv", "mlp"),
    "conv_b": ("layers", "batch", "conv", "ssm_state"),
    "conv_c": ("layers", "batch", "conv", "ssm_state"),
    "pos": (),
}


def zeros_cache(spec: Dict[str, TensorSpec], device) -> Dict[str, Any]:
    """A cache of zeros from its spec, ``pos`` the host int 0."""
    return {k: 0 if k == "pos" else
            torch.zeros(s.shape, dtype=s.dtype, device=device)
            for k, s in spec.items()}


def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    return zeros_cache(cache_spec(cfg, batch, max_len), device)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def weights_for_use(w):
    """A layer's weights (a namespace, a ``_Tree`` or a list) with every
    leaf through ``sharding.for_use``."""
    if isinstance(w, torch.Tensor):
        return for_use(w)
    if isinstance(w, (list, tuple, nn.ParameterList, nn.ModuleList)):
        return [weights_for_use(t) for t in w]
    keys = w._keys if isinstance(w, _Tree) else vars(w)
    return SimpleNamespace(**{k: weights_for_use(getattr(w, k))
                              for k in keys})


def constrain_layer_weights(w, cfg):
    """A layer's weights as its block uses them, inside the block (so
    that remat gathers them again in the backward, where the reference
    re-asserts their per-layer sharding for the same end): a ZeRO-3
    split is gathered (``sharding.for_use``); a no-op without an active
    mesh."""
    if get_mesh() is None:
        return w
    return weights_for_use(w)


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
    # the attention's sum over the heads is reduced here, as XLA's
    # propagation reduces it, not left to the MLP (DTensor would gather
    # the MLP's weights to keep a partial sum going)
    return constrain(x + a, ("batch", "seq", "embed")), new_kv


def dense_block(w, x, cfg, positions, cache_kv=None, cache_pos=None,
                mesh=None):
    """One block of the attention families on the layer weights ``w`` →
    (x, MoE aux loss or 0.0, new K/V pair or None)."""
    w = constrain_layer_weights(w, cfg)
    x, new_kv = _attn_block(w, x, cfg, positions, cache_kv, cache_pos)
    h = rms_norm(x, w.ln2, cfg.norm_eps)
    if cfg.family == "moe":
        f, aux = moe_mod.moe_ffn(w.moe, h, cfg, mesh)
    else:
        f, aux = swiglu(w.mlp, h), 0.0
    x = constrain(x + f, ("batch", "seq", "embed"))
    return x, aux, new_kv


def _rwkv_block(w, x, cfg, state=None):
    w = constrain_layer_weights(w, cfg)
    h = rms_norm(x, w.ln1, cfg.norm_eps)
    t, state = rwkv_mod.time_mix(w.rwkv, h, cfg, state)
    x = constrain(x + t, ("batch", "seq", "embed"))
    h = rms_norm(x, w.ln2, cfg.norm_eps)
    c, state = rwkv_mod.channel_mix(w.rwkv, h, state)
    x = constrain(x + c, ("batch", "seq", "embed"))
    return x, state


def _mamba_layer(w, x, cfg, state=None):
    w = constrain_layer_weights(w, cfg)
    h = rms_norm(x, w.ln, cfg.norm_eps)
    m, state = ssm_mod.mamba_block(w.mamba, h, cfg, state)
    x = constrain(x + m, ("batch", "seq", "embed"))
    return x, state


def _shared_attn_block(w, x, cfg, positions, cache_kv=None, cache_pos=None):
    w = constrain_layer_weights(w, cfg)
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


def remat_wanted(params, cfg, cache) -> bool:
    """Whether the blocks run under remat: ``cfg.remat``, no cache
    (training, not scoring or serving), autograd on and a weight that
    takes a gradient."""
    return (cfg.remat and cache is None and torch.is_grad_enabled()
            and any(p.requires_grad for p in params.parameters()))


def remat_block(block, w, x, cfg, *args):
    """``block(w, x, cfg, *args)`` under ``torch.utils.checkpoint``
    (non-reentrant): its activations are recomputed in the backward, as
    ``jax.remat`` of the reference's scan body recomputes them.  The same
    helper serves every block (dense, MoE, RWKV, Mamba, the hybrid's
    shared attention, encdec's encoder and decoder); ``remat_policy``
    ``"dots"`` keeps the weight products (``_dots_policy``).  Returns the
    block's own outputs."""
    kw = {}
    if cfg.remat_policy == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    return ckpt.checkpoint(block, w, x, cfg, *args, use_reentrant=False,
                           **kw)


def _run_attn_family(params: LM, x, cfg, positions, cache, mesh=None):
    remat = remat_wanted(params, cfg, cache)
    aux_total = 0.0
    for i, w in enumerate(params.layers):
        if remat:
            x, aux, _ = remat_block(dense_block, w, x, cfg, positions,
                                    None, None, mesh)
        else:
            ckv = (cache["k"][i], cache["v"][i]) if cache is not None \
                else None
            x, aux, _ = dense_block(w, x, cfg, positions, ckv,
                                    cache["pos"] if cache is not None
                                    else None, mesh)
        aux_total = aux_total + aux
    if cache is None:
        return x, aux_total, None
    return x, aux_total, dict(cache, pos=cache["pos"] + x.shape[1])


def _stacked(cache, new: Dict[str, list]) -> Dict[str, Any]:
    return dict(cache, **{k: torch.stack(v) for k, v in new.items()})


def _run_rwkv(params: LM, x, cfg, cache):
    remat = remat_wanted(params, cfg, cache)
    new = {"wkv": [], "shift_tm": [], "shift_cm": []}
    for i, w in enumerate(params.layers):
        if remat:
            x, _ = remat_block(_rwkv_block, w, x, cfg)
            continue
        st = (rwkv_mod.RWKVState(cache["wkv"][i], cache["shift_tm"][i],
                                 cache["shift_cm"][i])
              if cache is not None else None)
        x, st = _rwkv_block(w, x, cfg, st)
        if st is not None:
            for k in new:
                new[k].append(getattr(st, k))
    if cache is None:
        return x, None
    return x, _stacked(dict(cache, pos=cache["pos"] + x.shape[1]), new)


_SSM_KEYS = ("state", "conv_x", "conv_b", "conv_c")


def _run_hybrid(params: LM, x, cfg, positions, cache):
    """Mamba2 backbone; the weight-shared attention block before every
    ``attn_every``-th backbone layer, with its own KV cache for each
    application (written in place)."""
    L, ae = cfg.n_layers, cfg.hybrid.attn_every
    layers = params.layers
    shared = params.p.shared
    pos = cache["pos"] if cache is not None else None
    remat = remat_wanted(params, cfg, cache)
    new = {k: [] for k in _SSM_KEYS}
    for gi, lo in enumerate(range(0, L, ae)):
        if remat:
            x, _ = remat_block(_shared_attn_block, shared, x, cfg,
                               positions)
            for i in range(lo, min(lo + ae, L)):
                x, _ = remat_block(_mamba_layer, layers[i], x, cfg)
            continue
        ckv = ((cache["attn_k"][gi], cache["attn_v"][gi])
               if cache is not None else None)
        x, _ = _shared_attn_block(shared, x, cfg, positions, ckv,
                                  pos)
        for i in range(lo, min(lo + ae, L)):
            st = (ssm_mod.SSMState(*(cache[k][i] for k in _SSM_KEYS))
                  if cache is not None else None)
            x, st = _mamba_layer(layers[i], x, cfg, st)
            if st is not None:
                for k in _SSM_KEYS:
                    new[k].append(getattr(st, k))
    if cache is None:
        return x, None
    return x, _stacked(dict(cache, pos=pos + x.shape[1]), new)


# ---------------------------------------------------------------------------
# Public forward
# ---------------------------------------------------------------------------

class ForwardOut(NamedTuple):
    logits: torch.Tensor
    aux_loss: Any
    cache: Optional[Dict[str, Any]]


def forward(params: LM, batch: Dict[str, torch.Tensor], cfg,
            cache=None, mesh=None) -> ForwardOut:
    """batch: {'tokens': (B, S) int, optional 'patches': (B, P,
    patch_dim) (vlm), optional 'positions': (B, S)}.  ``mesh``: the
    ``DeviceMesh`` the DTensor weights and batch lie on (the MoE's
    paths take it; the caller enters ``sharding.mesh_scope``)."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(for_use(params.tok), tokens).to(torch_dtype(cfg.dtype))
    if cfg.family == "vlm" and batch.get("patches") is not None:
        p = torch.einsum("bpe,ed->bpd", batch["patches"].to(x.dtype),
                         for_use(params.p.patch_proj))
        x = torch.cat([p, x], dim=1)
        S = x.shape[1]
    if cfg.family == "ssm":
        x = rms_norm(x, for_use(params.p.ln_in), cfg.norm_eps)
    x = constrain(x, ("batch", "seq", "embed"))

    positions = batch.get("positions")
    if positions is None:
        start = cache["pos"] if cache is not None else 0
        positions = start + torch.arange(S, dtype=torch.int32,
                                         device=tokens.device)
        positions = positions[None].expand(B, S)

    aux = 0.0
    if cfg.family in ATTN_FAMILIES:
        x, aux, cache = _run_attn_family(params, x, cfg, positions, cache,
                                         mesh)
    elif cfg.family == "ssm":
        x, cache = _run_rwkv(params, x, cfg, cache)
    elif cfg.family == "hybrid":
        x, cache = _run_hybrid(params, x, cfg, positions, cache)
    else:
        raise ValueError(cfg.family)
    x = rms_norm(x, for_use(params.ln_f), cfg.norm_eps)
    return ForwardOut(logits_from(params, x, cfg), aux, cache)


def loss_from_logits(logits: torch.Tensor, batch, cfg,
                     aux_loss=0.0) -> torch.Tensor:
    """Next-token CE of ``forward``'s logits, as ``lm_loss`` takes it:
    VLM scores the text positions only, MoE adds ``0.01 · aux_loss``."""
    if cfg.family == "vlm":
        logits = logits[:, batch["patches"].shape[1]:]
    loss = cross_entropy(logits[:, :-1], batch["labels"][:, 1:],
                         batch.get("loss_mask"))
    if cfg.family == "moe":
        loss = loss + 0.01 * aux_loss
    return loss


def lm_loss(params: LM, batch, cfg, mesh=None) -> torch.Tensor:
    out = forward(params, batch, cfg, mesh=mesh)
    return loss_from_logits(out.logits, batch, cfg, out.aux_loss)
