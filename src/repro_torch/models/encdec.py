"""Encoder–decoder stack (the seamless-m4t backbone): the port of the JAX
package's ``models/encdec.py``.

The audio frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings ``(B, F, d_model)`` (``input_specs`` gives
their shape), passes them through a learned projection and a
bidirectional transformer encoder.  The decoder is a causal transformer
with cross-attention into the encoder's output.

Decode caches: the decoder's self-attention K/V (written in place, per
step) and the cross-attention K/V, computed at prefill from the encoder's
memory (new tensors in the returned cache) and read at decode, where the
cross scores are computed inline over every cached frame.

Under training (autograd on, no cache, ``cfg.remat``) each encoder and
decoder block runs under ``transformer.remat_block``, as the reference
remats its scan bodies.  Under a mesh the frame projection, the token
embedding and each block's output are ``constrain``ed to ``("batch",
"seq", "embed")`` where the reference constrains them, and each
attention's residual too (see ``transformer``).
"""
from __future__ import annotations

import math
from typing import Any, Dict

import torch

from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import constrain, for_use
from repro_torch.models.layers import (attention_defs, cross_entropy,
                                       embed_defs, embed_lookup, head_defs,
                                       head_proj, head_unproj, logits_from,
                                       multihead_attention, rms_norm, swiglu,
                                       swiglu_defs)
from repro_torch.models.layers import _attention_mesh
from repro_torch.models.params import ParamDef, TensorSpec, torch_dtype
from repro_torch.models.transformer import (ForwardOut,
                                            constrain_layer_weights,
                                            remat_block, remat_wanted,
                                            zeros_cache)


def encdec_defs(cfg) -> Dict[str, Any]:
    Le = cfg.encdec.n_encoder_layers
    Ld = cfg.n_layers
    D = cfg.d_model
    return {
        "embed": embed_defs(cfg),
        "frame_proj": ParamDef((D, D), ("frames", "embed")),
        "encoder": {
            "ln1": ParamDef((Le, D), ("layers", "embed"), init="ones"),
            "ln2": ParamDef((Le, D), ("layers", "embed"), init="ones"),
            "attn": attention_defs(cfg, n_layers=Le),
            "mlp": swiglu_defs(cfg, n_layers=Le),
        },
        "ln_enc": ParamDef((D,), ("embed",), init="ones"),
        "decoder": {
            "ln1": ParamDef((Ld, D), ("layers", "embed"), init="ones"),
            "ln_x": ParamDef((Ld, D), ("layers", "embed"), init="ones"),
            "ln2": ParamDef((Ld, D), ("layers", "embed"), init="ones"),
            "attn": attention_defs(cfg, n_layers=Ld),
            "xattn": attention_defs(cfg, n_layers=Ld),
            "mlp": swiglu_defs(cfg, n_layers=Ld),
        },
        "ln_f": ParamDef((D,), ("embed",), init="ones"),
        "head": head_defs(cfg),
    }


def encdec_cache_spec(cfg, batch: int, max_dec: int, n_frames: int
                      ) -> Dict[str, TensorSpec]:
    dt = torch_dtype(cfg.dtype)
    KV, Hd, Ld = cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    S = TensorSpec
    return {"k": S((Ld, batch, max_dec, KV, Hd), dt),
            "v": S((Ld, batch, max_dec, KV, Hd), dt),
            "xk": S((Ld, batch, n_frames, KV, Hd), dt),
            "xv": S((Ld, batch, n_frames, KV, Hd), dt),
            "pos": S((), torch.int32)}


def init_encdec_cache(cfg, batch: int, max_dec: int, n_frames: int,
                      device="cuda"):
    return zeros_cache(encdec_cache_spec(cfg, batch, max_dec, n_frames),
                       device)


def encode(params, frames: torch.Tensor, cfg,
           remat: bool = False) -> torch.Tensor:
    """frames: (B, F, d_model) stub embeddings → encoder memory (B, F, D);
    with ``remat`` each block under ``transformer.remat_block``."""
    x = frames.to(torch_dtype(cfg.dtype)) @ for_use(params.p.frame_proj)
    x = constrain(x, ("batch", "seq", "embed"))
    B, F_, D = x.shape
    positions = torch.arange(F_, dtype=torch.int32, device=x.device)
    positions = positions[None].expand(B, F_)
    for w in params.views("encoder"):
        x = (remat_block(_encoder_block, w, x, cfg, positions) if remat
             else _encoder_block(w, x, cfg, positions))
    return rms_norm(x, for_use(params.p.ln_enc), cfg.norm_eps)


def _encoder_block(w, x, cfg, positions):
    w = constrain_layer_weights(w, cfg)
    h = rms_norm(x, w.ln1, cfg.norm_eps)
    x = constrain(x + multihead_attention(w.attn, h, cfg=cfg,
                                          positions=positions, causal=False),
                  ("batch", "seq", "embed"))
    h = rms_norm(x, w.ln2, cfg.norm_eps)
    return constrain(x + swiglu(w.mlp, h), ("batch", "seq", "embed"))


def _decoder_block(w, x, cfg, positions, memory, self_kv=None, cross_kv=None,
                   cache_pos=None):
    w = constrain_layer_weights(w, cfg)
    h = rms_norm(x, w.ln1, cfg.norm_eps)
    if self_kv is not None:
        a, self_kv = multihead_attention(w.attn, h, cfg=cfg,
                                         positions=positions,
                                         kv_cache=self_kv,
                                         cache_pos=cache_pos)
    else:
        a = multihead_attention(w.attn, h, cfg=cfg, positions=positions)
    x = constrain(x + a, ("batch", "seq", "embed"))
    h = rms_norm(x, w.ln_x, cfg.norm_eps)
    if memory is not None:
        # prefill / training: keys from memory
        a = multihead_attention(w.xattn, h, cfg=cfg, positions=positions,
                                causal=False, memory=memory)
        if cross_kv is not None:
            # also the cross K/V for later decode
            k = head_proj(memory, w.xattn.wk, "btd,dkh->btkh")
            v = head_proj(memory, w.xattn.wv, "btd,dkh->btkh")
            cross_kv = (k.to(cross_kv[0].dtype), v.to(cross_kv[1].dtype))
    else:
        # decode: cross K/V from the cache
        xk, xv = cross_kv
        B, S, D = h.shape
        H, KV, Hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
        q = head_proj(h, w.xattn.wq)
        if isinstance(q, DTensor):
            # every cached frame, as attention with an all-true mask
            qpos = torch.zeros((B, S), dtype=torch.int32, device=h.device)
            kpos = torch.zeros((B, xk.shape[1]), dtype=torch.int32,
                               device=h.device)
            o = _attention_mesh(q, xk, xv, qpos, kpos, 1.0 / math.sqrt(Hd),
                                torch.float32, cached=True)
        else:
            q = q.reshape(B, S, KV, H // KV, Hd)
            scores = torch.einsum("bskgh,btkh->bkgst", q.float(),
                                  xk.float()) / math.sqrt(Hd)
            probs = torch.softmax(scores, dim=-1).to(xv.dtype)
            o = torch.einsum("bkgst,btkh->bskgh", probs, xv).reshape(
                B, S, H, Hd)
        a = head_unproj(o, w.xattn.wo)
    x = constrain(x + a, ("batch", "seq", "embed"))
    h = rms_norm(x, w.ln2, cfg.norm_eps)
    x = constrain(x + swiglu(w.mlp, h), ("batch", "seq", "embed"))
    return x, self_kv, cross_kv


def forward(params, batch, cfg, cache=None, mesh=None) -> ForwardOut:
    """batch: {'frames': (B, F, D) or absent (decode), 'tokens': (B, S)}.
    ``mesh`` is taken for the API's sake: no op of this family needs it
    beyond ``constrain``."""
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = embed_lookup(for_use(params.tok), tokens).to(torch_dtype(cfg.dtype))
    x = constrain(x, ("batch", "seq", "embed"))

    start = cache["pos"] if cache is not None else 0
    positions = batch.get("positions")
    if positions is None:
        positions = start + torch.arange(S, dtype=torch.int32,
                                         device=tokens.device)
        positions = positions[None].expand(B, S)

    remat = remat_wanted(params, cfg, cache)
    memory = None
    if batch.get("frames") is not None:
        memory = encode(params, batch["frames"], cfg, remat)

    xk, xv = [], []
    for i, w in enumerate(params.views("decoder")):
        if remat:
            x, _, _ = remat_block(_decoder_block, w, x, cfg, positions,
                                  memory)
            continue
        skv = (cache["k"][i], cache["v"][i]) if cache is not None else None
        xkv = (cache["xk"][i], cache["xv"][i]) if cache is not None else None
        x, _, xkv = _decoder_block(w, x, cfg, positions, memory, skv, xkv,
                                   start if cache is not None else None)
        if memory is not None and xkv is not None:
            xk.append(xkv[0])
            xv.append(xkv[1])
    if cache is not None:
        # the self K/V were written in place; new cross K/V at prefill
        cache = dict(cache, pos=start + S)
        if xk:
            cache.update(xk=torch.stack(xk), xv=torch.stack(xv))

    x = rms_norm(x, for_use(params.ln_f), cfg.norm_eps)
    return ForwardOut(logits_from(params, x, cfg), 0.0, cache)


def lm_loss(params, batch, cfg, mesh=None) -> torch.Tensor:
    out = forward(params, batch, cfg, mesh=mesh)
    return cross_entropy(out.logits[:, :-1], batch["labels"][:, 1:],
                         batch.get("loss_mask"))
