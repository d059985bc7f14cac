"""Model API of the port, over every LM family.

``Model(cfg, device)`` exposes what the JAX package's ``Model`` does:

* ``param_defs / init_params``: the parameter tree and its random weights
  (the JAX package's weights for the same key) as an ``LM`` module;
* ``abstract_params / param_dims``: each leaf's ``TensorSpec`` (shape and
  dtype) and logical dims, without drawing it;
* ``loss(params, batch, mesh=None)``: the training objective
  (``training.steps`` differentiates it);
* ``forward(params, batch, cache=None, mesh=None)``;
* ``prefill(params, batch, cache, mesh=None)``: context ingest, writes
  the cache;
* ``decode_step(params, batch, cache, mesh=None)``: one token, updates
  the cache;
* ``cache_abstract(batch, seq)`` / ``init_cache(batch, seq)`` /
  ``cache_dims()``;
* ``input_specs(shape)`` / ``batch_dims(batch)``: the ``TensorSpec`` of
  every input of a ``ShapeSpec`` cell, and their logical dims.

Shape semantics of the special families, as in the reference:

* ``encdec``: ``seq_len`` is split ``encoder_frac`` / rest between stub
  audio frames and decoder tokens; decode runs the decoder with a self
  cache of ``seq_len − frames`` and a cross cache over the frames.
* ``vlm``: ``n_patches`` stub patch embeddings are prepended; the text is
  ``seq_len − n_patches`` tokens, so the whole context matches the cell.

Everything runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU).  With ``mesh`` (a ``DeviceMesh``) the weights, batch and cache are
DTensors on it, laid out by ``training.steps.build_cell``, and each step
runs under ``distributed.sharding.mesh_scope``.  An unknown family
raises ``ValueError`` where it is first used.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.distributed.sharding import mesh_scope, unsplit
from repro_torch.models import encdec as encdec_mod
from repro_torch.models import transformer as tf_mod
from repro_torch.models.params import (TensorSpec, abstract_params,
                                       init_params, param_dims, torch_dtype)

BATCH_DIMS = {
    "tokens": ("batch", "seq"),
    "labels": ("batch", "seq"),
    "positions": ("batch", "seq"),
    "loss_mask": ("batch", "seq"),
    "patches": ("batch", "patches", "patch_dim"),
    "frames": ("batch", "frames", "embed"),
}


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self._encdec = cfg.family == "encdec"
        self._mod = encdec_mod if self._encdec else tf_mod

    # -- parameters ---------------------------------------------------------
    def param_defs(self):
        if self._encdec:
            return encdec_mod.encdec_defs(self.cfg)
        return tf_mod.stack_defs(self.cfg)

    def abstract_params(self):
        return abstract_params(self.param_defs(), self.cfg.dtype)

    def init_params(self, key: torch.Tensor) -> tf_mod.LM:
        """``key``: a ``repro_torch.random`` key (``random.PRNGKey(0)``)."""
        tree = init_params(self.param_defs(), key, self.cfg.dtype,
                           self.device)
        return tf_mod.LM(tree, self.cfg)

    def param_dims(self):
        return param_dims(self.param_defs())

    # -- steps ---------------------------------------------------------------
    def loss(self, params, batch, mesh=None):
        with mesh_scope(self.cfg, mesh):
            return self._mod.lm_loss(params, batch, self.cfg, mesh)

    def forward(self, params, batch, cache=None,
                mesh=None) -> tf_mod.ForwardOut:
        with mesh_scope(self.cfg, mesh):
            return self._mod.forward(params, batch, self.cfg, cache, mesh)

    def prefill(self, params, batch, cache, mesh=None):
        with mesh_scope(self.cfg, mesh):
            out = self.forward(params, batch, cache=cache, mesh=mesh)
            return out.logits[:, -1], out.cache

    def decode_step(self, params, batch, cache, mesh=None):
        """batch['tokens']: (B, 1).  Returns (next_token (B,) int32, cache)."""
        with mesh_scope(self.cfg, mesh):
            out = self.forward(params, batch, cache=cache, mesh=mesh)
            # the vocab whole on each rank (DTensor's argmax over a split
            # dim gathers its own way)
            last = unsplit(out.logits[:, -1].float(), -1)
            next_tok = torch.argmax(last, dim=-1)
            return next_tok.to(torch.int32), out.cache

    # -- caches ---------------------------------------------------------------
    def cache_abstract(self, batch: int, seq: int):
        cfg = self.cfg
        if self._encdec:
            fr = int(seq * cfg.encdec.encoder_frac)
            return encdec_mod.encdec_cache_spec(cfg, batch, seq - fr, fr)
        return tf_mod.cache_spec(cfg, batch, seq)

    def init_cache(self, batch: int, seq: int):
        return tf_mod.zeros_cache(self.cache_abstract(batch, seq),
                                  self.device)

    def cache_dims(self):
        dims = dict(tf_mod.CACHE_DIMS)
        dims.update(xk=tf_mod.CACHE_DIMS["k"], xv=tf_mod.CACHE_DIMS["v"])
        return dims

    # -- input specs ----------------------------------------------------------
    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """Shapes and dtypes of one cell's inputs (nothing allocated)."""
        cfg = self.cfg
        B, S, i32 = shape.global_batch, shape.seq_len, torch.int32
        SD = TensorSpec
        dt = torch_dtype(cfg.dtype)
        if shape.kind == "decode":
            # one token against a cache of length seq_len
            return {"tokens": SD((B, 1), i32)}
        keys = ("tokens", "labels") if shape.kind == "train" else ("tokens",)
        if self._encdec:
            fr = int(S * cfg.encdec.encoder_frac)
            return {"frames": SD((B, fr, cfg.d_model), dt),
                    **{k: SD((B, S - fr), i32) for k in keys}}
        if cfg.family == "vlm":
            p = cfg.vlm.n_patches
            return {**{k: SD((B, S - p), i32) for k in keys},
                    "patches": SD((B, p, cfg.vlm.patch_dim), dt)}
        return {k: SD((B, S), i32) for k in keys}

    def batch_dims(self, batch: Dict[str, Any]):
        return {k: BATCH_DIMS[k] for k in batch}
