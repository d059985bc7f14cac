"""Batched serving engine with continuous batching: the port of the JAX
package's ``serving/engine.py``.

One fixed-shape decode serves a dynamic request queue: the KV cache holds
``max_batch`` slots; finished or empty slots are refilled by prefilling an
incoming prompt into the slot's cache lines, so decode keeps one shape.

Per-slot state: current position, active request, generated tokens.
``run`` drives the loop until every request is done.  The greedy
``argmax`` is taken in float32.  A slot's prefill goes through the cache,
so attention takes the einsum path, as in the reference (the flash kernel
serves only cache-less scoring).  The slot is prefilled through a view of
the cache's slot (``(L, 1, ...)``) with ``pos = 0``; attention writes its
K/V into that view in place, and every tensor of the returned cache (the
SSM and WKV states are new tensors) is then written back into the slot
from index 0 of each further dim, as the reference's
``dynamic_update_slice_in_dim`` writes it: a returned tensor shorter than
the slot's (a hybrid prompt shorter than ``d_conv - 1`` leaves a shorter
conv buffer, ROADMAP C13) updates only its leading rows.  As in the
reference, the prefill reads the slot's cache as it finds it: a reused
slot's SSM or WKV state is where the next prompt's scan starts (C16).
The engine
passes tokens and positions only, as the reference's does: a VLM's
patches and an encdec's frames never reach it (ROADMAP C14).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.model import Model


def _update_slot(full: torch.Tensor, new: torch.Tensor, slot: int) -> None:
    """``full[:, slot]`` ← ``new[:, 0]`` at index 0 of every further dim:
    ``dynamic_update_slice_in_dim(full, new, slot, axis=1)``."""
    dst = full[(slice(None), slice(slot, slot + 1))
               + tuple(slice(0, n) for n in new.shape[2:])]
    if dst.data_ptr() != new.data_ptr():      # K/V were written in place
        dst.copy_(new)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray           # (len,) int32
    max_new: int = 16
    out: Optional[List[int]] = None


class ServingEngine:
    def __init__(self, model: Model, params, max_batch: int = 4,
                 max_len: int = 256):
        self.model = model
        self.params = params
        self.B = max_batch
        self.L = max_len
        self.device = model.device
        self.cache = model.init_cache(max_batch, max_len)
        self.pos = np.zeros(max_batch, np.int64)
        self.active: List[Optional[Request]] = [None] * max_batch

    def _next_tokens(self, logits: torch.Tensor) -> np.ndarray:
        nxt = torch.argmax(logits[:, -1].float(), dim=-1).to(torch.int32)
        return nxt.cpu().numpy()

    @torch.no_grad()
    def _decode(self, tokens: np.ndarray, positions: np.ndarray) -> np.ndarray:
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "positions": torch.from_numpy(positions).to(self.device)}
        out = self.model.forward(self.params, batch, cache=self.cache)
        self.cache = out.cache
        return self._next_tokens(out.logits)

    @torch.no_grad()
    def _prefill_slot(self, tokens: np.ndarray, slot: int) -> np.ndarray:
        """Prefill one request into one batch slot (others untouched)."""
        T = tokens.shape[1]
        batch = {"tokens": torch.from_numpy(tokens).to(self.device),
                 "positions": torch.arange(T, dtype=torch.int32,
                                           device=self.device)[None]}
        one = {k: c[:, slot:slot + 1] for k, c in self.cache.items()
               if k != "pos"}
        out = self.model.forward(self.params, batch, cache=dict(one, pos=0))
        for k, new in out.cache.items():
            if k != "pos":
                _update_slot(self.cache[k], new, slot)
        return self._next_tokens(out.logits)

    # -- scheduling ---------------------------------------------------------
    def _admit(self, req: Request, slot: int):
        tokens = np.asarray(req.prompt, np.int32)[None]
        nxt = self._prefill_slot(tokens, slot)
        req.out = [int(nxt[0])]
        self.active[slot] = req
        self.pos[slot] = tokens.shape[1]

    def run(self, requests: List[Request]) -> Dict[int, List[int]]:
        pending = list(requests)
        results: Dict[int, List[int]] = {}
        # token buffer fed each decode step
        cur = np.zeros((self.B, 1), np.int32)
        while pending or any(a is not None for a in self.active):
            # admit
            for slot in range(self.B):
                if self.active[slot] is None and pending:
                    self._admit(pending.pop(0), slot)
                    cur[slot, 0] = self.active[slot].out[-1]
            # decode one step for all active slots
            nxt = self._decode(cur, self.pos[:, None].astype(np.int32))
            for slot in range(self.B):
                req = self.active[slot]
                if req is None:
                    continue
                req.out.append(int(nxt[slot]))
                self.pos[slot] += 1
                cur[slot, 0] = nxt[slot]
                done = (len(req.out) >= req.max_new
                        or self.pos[slot] >= self.L - 1)
                if done:
                    results[req.rid] = req.out
                    self.active[slot] = None
        return results
