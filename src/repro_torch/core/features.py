"""GAN feature generation (paper §3.3), inference side.

The generator is the paper's ``θ(ResBlock(...(FC(z))))`` with
``ResBlock(x) = x + ReLU(FC(BatchNorm(x)))`` (dropout is off at
inference).  Weights come from a JAX-trained fit, in its ``(din, dout)``
layout (``repro_torch.convert``); training waits for a later slice.

BatchNorm uses the *batch* statistics at inference too, as the reference
does (``var`` over the block, ddof 0), so a row's output depends on the
block it is drawn in.  ``sample`` keeps the reference's block rule: an
explicit ``batch`` is honored exactly, the default is
``min(sample_batch, n)``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import random as trandom
from repro_torch.core.feature_engine import BatchedDecoder
from repro_torch.tabular import vgm as vgm_mod
from repro_torch.tabular.schema import TableSchema


class TableCodec:
    """The fitted mode-specific normalization: one VGM per continuous
    column and the number of modes."""

    def __init__(self, schema: TableSchema, n_modes: int = 5,
                 vgms: Optional[List[vgm_mod.VGMParams]] = None):
        self.schema = schema
        self.n_modes = n_modes
        self.vgms: List[vgm_mod.VGMParams] = list(vgms or [])

    @property
    def enc_dim(self) -> int:
        return (1 + self.n_modes) * self.schema.n_cont \
            + sum(self.schema.cat_cards)

    def batched(self, batch: int = 1 << 16, device="cuda") -> BatchedDecoder:
        return BatchedDecoder(self.schema, self.vgms, self.n_modes, batch,
                              device)


class Dense(nn.Module):
    """``x @ w + b`` with ``w`` in the JAX ``(din, dout)`` layout."""

    def __init__(self, din: int, dout: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(din, dout))
        self.b = nn.Parameter(torch.zeros(dout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b


class BatchNorm(nn.Module):
    """Normalization by the batch's own mean and (ddof 0) variance."""

    def __init__(self, d: int, eps: float = 1e-5):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mu = x.mean(0, keepdim=True)
        var = x.var(0, unbiased=False, keepdim=True)
        return (x - mu) / torch.sqrt(var + self.eps) * self.scale + self.bias


class ResBlock(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.bn = BatchNorm(d)
        self.fc = Dense(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + torch.relu(self.fc(self.bn(x)))


class GeneratorMLP(nn.Module):
    def __init__(self, d_in: int, d_hid: int, n_blocks: int, d_out: int):
        super().__init__()
        self.inp = Dense(d_in, d_hid)
        self.blocks = nn.ModuleList(ResBlock(d_hid) for _ in range(n_blocks))
        self.out = Dense(d_hid, d_out)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = self.inp(z)
        for blk in self.blocks:
            h = blk(h)
        return self.out(h)

    def load_jax_params(self, p: Dict) -> "GeneratorMLP":
        """Load the JAX ``{"in", "blocks", "out"}`` parameter tree (numpy
        leaves, ``(din, dout)`` weights)."""
        def put(param, value):
            param.data = torch.as_tensor(np.array(value, np.float32),
                                         device=param.device).clone()
        put(self.inp.w, p["in"]["w"])
        put(self.inp.b, p["in"]["b"])
        for blk, pb in zip(self.blocks, p["blocks"]):
            put(blk.bn.scale, pb["bn"]["scale"])
            put(blk.bn.bias, pb["bn"]["bias"])
            put(blk.fc.w, pb["fc"]["w"])
            put(blk.fc.b, pb["fc"]["b"])
        put(self.out.w, p["out"]["w"])
        put(self.out.b, p["out"]["b"])
        return self


@dataclasses.dataclass
class GANConfig:
    d_z: int = 64
    n_blocks: int = 2
    sample_batch: int = 1 << 16   # rows per inference block


class GANFeatureGenerator:
    def __init__(self, schema: TableSchema, codec: TableCodec,
                 generator: GeneratorMLP, cfg: Optional[GANConfig] = None,
                 device="cuda"):
        self.schema = schema
        self.cfg = cfg if cfg is not None else GANConfig()
        self.codec = codec
        self.device = torch.device(device)
        self.generator = generator.to(self.device).eval()
        self._decoders: Dict[int, BatchedDecoder] = {}

    def _activate(self, raw: torch.Tensor) -> torch.Tensor:
        """tanh on each α column, softmax over each mode / category
        group."""
        outs = []
        off = 0
        nm = self.codec.n_modes
        for _ in range(self.schema.n_cont):
            outs.append(torch.tanh(raw[:, off: off + 1]))
            outs.append(torch.softmax(raw[:, off + 1: off + 1 + nm], -1))
            off += 1 + nm
        for card in self.schema.cat_cards:
            outs.append(torch.softmax(raw[:, off: off + card], -1))
            off += card
        return torch.cat(outs, 1) if outs else raw

    def block_draw(self, batch: int):
        """The per-block draw ``key → (cont, cat)`` for ``batch`` rows:
        ``kz, kg, kd = split(key, 3)``, generator on ``normal(kz)``,
        activation, Gumbel-max decode with ``kd`` (``kg`` is the dropout
        key, unused at inference)."""
        b = int(batch)
        if b not in self._decoders:
            self._decoders[b] = self.codec.batched(b, self.device)
        decoder = self._decoders[b]

        @torch.no_grad()
        def _draw(key: torch.Tensor):
            kz, _, kd = trandom.split(key, 3)
            z = trandom.normal(kz, (b, self.cfg.d_z), self.device)
            raw = self._activate(self.generator(z))
            return decoder.decode_traceable(raw, kd)

        return _draw

    def sample(self, rng: np.random.Generator, n: int,
               batch: Optional[int] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Draw ``n`` rows in blocks; block ``i`` uses
        ``fold_in(key, i)`` with ``key = PRNGKey(rng.integers(2**63))``
        (cut to 32 bits, as in the reference)."""
        if n == 0:
            return (torch.zeros((0, self.schema.n_cont), dtype=torch.float32,
                                device=self.device),
                    torch.zeros((0, self.schema.n_cat), dtype=torch.int32,
                                device=self.device))
        key = trandom.PRNGKey(int(rng.integers(2 ** 63)))
        b = (max(1, int(batch)) if batch
             else max(1, min(int(self.cfg.sample_batch), n)))
        draw = self.block_draw(b)
        conts, cats = [], []
        for i in range(-(-n // b)):
            c, k = draw(trandom.fold_in(key, i))
            conts.append(c)
            cats.append(k)
        return torch.cat(conts)[:n], torch.cat(cats)[:n]
