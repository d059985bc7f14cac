"""Batched feature decode (hot path of §3.3–§3.4).

* :class:`BatchedDecoder` — GAN-space → table decoding with Gumbel-max
  categorical sampling over fixed-size blocks, on the device of its
  inputs.  ``decode_traceable`` maps one block and one key to
  ``(cont, cat)``; the GAN sampler calls it right after its generator.
* :func:`batched_rows` — the fixed-size block driver: pads the tail block
  with zeros so every call sees the same shape.  A row's output can depend
  on its block (the GAN's batch statistics, per-block keys), so the block
  rule is the JAX package's, not a free choice.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import random as trandom
from repro_torch.tabular import vgm as vgm_mod
from repro_torch.tabular.schema import TableSchema


def batched_rows(fn: Callable, X: torch.Tensor, batch: int,
                 with_index: bool = False):
    """Apply ``fn`` over the rows of ``X`` in blocks of ``batch`` rows,
    zero-padding the tail block, and trim the concatenated outputs back
    to ``len(X)`` rows.  ``fn`` returns a tensor or a tuple of tensors;
    with ``with_index=True`` it is called as ``fn(block, i)``."""
    call = fn if with_index else (lambda blk, i: fn(blk))
    n = len(X)
    if n == 0:
        out = call(torch.zeros((1,) + tuple(X.shape[1:]), dtype=X.dtype,
                               device=X.device), 0)
        if isinstance(out, tuple):
            return tuple(o[:0] for o in out)
        return out[:0]
    b = max(1, int(batch))
    n_blocks = math.ceil(n / b)
    pad = n_blocks * b - n
    blocks = [X[i * b:(i + 1) * b] for i in range(n_blocks)]
    if pad:
        tail = torch.zeros((b,) + tuple(X.shape[1:]), dtype=X.dtype,
                           device=X.device)
        tail[:b - pad] = blocks[-1]
        blocks[-1] = tail
    outs = [call(blk, i) for i, blk in enumerate(blocks)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat([o[j] for o in outs])[:n]
                     for j in range(len(outs[0])))
    return torch.cat(outs)[:n]


class BatchedDecoder:
    """GAN output → (cont, cat) decoding.

    Mode and category ids are drawn with Gumbel-max over the (masked)
    probability rows, in range by construction."""

    def __init__(self, schema: TableSchema, vgms: Sequence[vgm_mod.VGMParams],
                 n_modes: int, batch: int = 1 << 16, device="cuda"):
        assert len(vgms) == schema.n_cont, (len(vgms), schema.n_cont)
        self.schema = schema
        self.n_modes = int(n_modes)
        self.batch = int(batch)
        self.device = torch.device(device)
        means, stds, active = vgm_mod.stack_params(vgms, schema.n_cont,
                                                   n_modes)
        self.means = torch.as_tensor(means, device=self.device)
        self.stds = torch.as_tensor(stds, device=self.device)
        self.active = torch.as_tensor(active, device=self.device)

    def decode_traceable(self, raw: torch.Tensor, key: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
        """raw: (B, enc_dim) activated generator output → cont (B, n_cont)
        float32, cat (B, n_cat) int32.  One key per column, from
        ``split(key, n_cont + n_cat)``."""
        nc, K = self.schema.n_cont, self.n_modes
        keys = trandom.split(key, max(nc + self.schema.n_cat, 1))
        dev = raw.device
        conts: List[torch.Tensor] = []
        cats: List[torch.Tensor] = []
        off, ki = 0, 0
        for j in range(nc):
            alpha = torch.clamp(raw[:, off], -1.0, 1.0)
            probs = raw[:, off + 1: off + 1 + K]
            logits = torch.where(self.active[j],
                                 torch.log(torch.clamp_min(probs, 1e-9)),
                                 -torch.inf)
            g = trandom.gumbel(keys[ki], probs.shape, dev)
            mode = torch.argmax(logits + g, dim=1)
            conts.append(self.means[j, mode]
                         + alpha * 4.0 * self.stds[j, mode])
            off += 1 + K
            ki += 1
        for card in self.schema.cat_cards:
            logits = torch.log(torch.clamp_min(raw[:, off: off + card], 1e-9))
            g = trandom.gumbel(keys[ki], logits.shape, dev)
            cats.append(torch.argmax(logits + g, dim=1).to(torch.int32))
            off += card
            ki += 1
        B = raw.shape[0]
        cont = (torch.stack(conts, 1) if conts
                else torch.zeros((B, 0), dtype=torch.float32, device=dev))
        cat = (torch.stack(cats, 1) if cats
               else torch.zeros((B, 0), dtype=torch.int32, device=dev))
        return cont, cat

    def decode(self, raw: torch.Tensor, rng: np.random.Generator,
               batch: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Decode any number of rows in blocks of ``batch``; block ``i``
        uses ``fold_in(key, i)``.  The key comes from ``rng.integers(2**63)``
        cut to 32 bits, as the reference's ``PRNGKey`` cuts it."""
        key = trandom.PRNGKey(int(rng.integers(2 ** 63)))
        return batched_rows(
            lambda blk, i: self.decode_traceable(blk,
                                                 trandom.fold_in(key, i)),
            raw, batch or self.batch, with_index=True)
