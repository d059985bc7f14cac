"""Model API of the port, over the dense LM family.

``Model(cfg, device)`` exposes what the JAX package's ``Model`` does for
scoring and serving:

* ``param_defs / init_params``: the parameter tree and its random weights
  (the JAX package's weights for the same key) as a ``DenseLM`` module;
* ``forward(params, batch, cache=None)`` and ``loss(params, batch)``;
* ``prefill(params, batch, cache)``: context ingest, writes the cache;
* ``decode_step(params, batch, cache)``: one token, updates the cache;
* ``cache_abstract(batch, seq)`` / ``init_cache(batch, seq)``.

Everything runs on ``device`` (``"cuda"`` unless the caller asks for the
CPU).  Other families raise ``NotImplementedError`` (ROADMAP A7(b)).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as tf_mod
from repro_torch.models.params import init_params


class Model:
    def __init__(self, cfg: ModelConfig, device="cuda"):
        tf_mod._require_dense(cfg)
        self.cfg = cfg
        self.device = torch.device(device)

    # -- parameters ---------------------------------------------------------
    def param_defs(self):
        return tf_mod.stack_defs(self.cfg)

    def init_params(self, key: torch.Tensor) -> tf_mod.DenseLM:
        """``key``: a ``repro_torch.random`` key (``random.PRNGKey(0)``)."""
        tree = init_params(self.param_defs(), key, self.cfg.dtype,
                           self.device)
        return tf_mod.DenseLM(tree, self.cfg)

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
