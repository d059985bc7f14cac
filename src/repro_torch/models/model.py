"""Model API of the port, over the dense LM family.

``Model(cfg, device)`` exposes what the JAX package's ``Model`` does:

* ``param_defs / init_params``: the parameter tree and its random weights
  (the JAX package's weights for the same key) as a ``DenseLM`` module;
* ``abstract_params / param_dims``: each leaf's ``TensorSpec`` (shape and
  dtype) and logical dims, without drawing it;
* ``loss(params, batch)``: the training objective (``training.steps``
  differentiates it);
* ``forward(params, batch, cache=None)``;
* ``prefill(params, batch, cache)``: context ingest, writes the cache;
* ``decode_step(params, batch, cache)``: one token, updates the cache;
* ``cache_abstract(batch, seq)`` / ``init_cache(batch, seq)``;
* ``input_specs(shape)`` / ``batch_dims(batch)``: the ``TensorSpec`` of
  every input of a ``ShapeSpec`` cell, and their logical dims.

Everything runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU).  Other families raise ``NotImplementedError`` (ROADMAP A7(b)).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import transformer as tf_mod
from repro_torch.models.params import (TensorSpec, abstract_params,
                                       init_params, param_dims)

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
        tf_mod._require_dense(cfg)
        self.cfg = cfg
        self.device = torch.device(device)

    # -- parameters ---------------------------------------------------------
    def param_defs(self):
        return tf_mod.stack_defs(self.cfg)

    def abstract_params(self):
        return abstract_params(self.param_defs(), self.cfg.dtype)

    def init_params(self, key: torch.Tensor) -> tf_mod.DenseLM:
        """``key``: a ``repro_torch.random`` key (``random.PRNGKey(0)``)."""
        tree = init_params(self.param_defs(), key, self.cfg.dtype,
                           self.device)
        return tf_mod.DenseLM(tree, self.cfg)

    def param_dims(self):
        return param_dims(self.param_defs())

    # -- steps ---------------------------------------------------------------
    def loss(self, params, batch):
        return tf_mod.lm_loss(params, batch, self.cfg)

    def forward(self, params, batch, cache=None) -> tf_mod.ForwardOut:
        return tf_mod.forward(params, batch, self.cfg, cache)

    def prefill(self, params, batch, cache):
        out = self.forward(params, batch, cache=cache)
        return out.logits[:, -1], out.cache

    def decode_step(self, params, batch, cache):
        """batch['tokens']: (B, 1).  Returns (next_token (B,) int32, cache)."""
        out = self.forward(params, batch, cache=cache)
        next_tok = torch.argmax(out.logits[:, -1].float(), dim=-1)
        return next_tok.to(torch.int32), out.cache

    # -- caches ---------------------------------------------------------------
    def cache_abstract(self, batch: int, seq: int):
        return tf_mod.cache_spec(self.cfg, batch, seq)

    def init_cache(self, batch: int, seq: int):
        return tf_mod.init_cache(self.cfg, batch, seq, self.device)

    # -- input specs ----------------------------------------------------------
    def input_specs(self, shape: ShapeSpec) -> Dict[str, Any]:
        """Shapes and dtypes of one cell's inputs (nothing allocated)."""
        B, S, i32 = shape.global_batch, shape.seq_len, torch.int32
        if shape.kind == "train":
            return {"tokens": TensorSpec((B, S), i32),
                    "labels": TensorSpec((B, S), i32)}
        if shape.kind == "prefill":
            return {"tokens": TensorSpec((B, S), i32)}
        # decode: one token against a cache of length seq_len
        return {"tokens": TensorSpec((B, 1), i32)}

    def batch_dims(self, batch: Dict[str, Any]):
        return {k: BATCH_DIMS[k] for k in batch}
