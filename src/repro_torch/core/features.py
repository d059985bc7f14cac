"""Feature generation (paper §3.3): the codec, the GAN's training and
sampling, and the KDE and Random baselines of the ablation (Table 6).

Generator and discriminator are both the paper's
``θ(ResBlock(...(FC(x))))`` with ``ResBlock(x) = x + Dropout(ReLU(FC(
BatchNorm(x))))``, weights in the JAX package's ``(din, dout)`` layout.
``GANFeatureGenerator.fit`` trains them as the reference does: the same
threefry keys, batch indices, dropout masks and initial weights, the
standard GAN objective with the non-saturating G loss, and Adam written
out as the reference writes it.  Gradients come from ``torch.autograd``;
every step runs eagerly on ``device``.  The codec (``TableCodec.fit`` /
``encode``) is host numpy, bit for bit the reference's.

BatchNorm uses the *batch* statistics in training and at inference, as
the reference does (``var`` over the batch, ddof 0), so a row's output
depends on the block it is drawn in.  ``sample`` keeps the reference's
block rule: an explicit ``batch`` is honored exactly, the default is
``min(sample_batch, n)``.

``TableCodec.decode``/``decode_reference`` and the KDE and Random
generators are the reference's numpy on the host, draw for draw, so a seed
gives its bytes.  KDE moves the edge-sized arithmetic to its ``device``
where the bytes stay IEEE-equal: the row gather and ``+ normal · bw`` in
float64, cast to float32 after, and each category's bin search
(``baselines.choice_indices``).  All three generators share::

    gen = KDEFeatureGenerator(schema, device="cuda").fit(cont, cat)
    cont_s, cat_s = gen.sample(rng, n)     # device float32 / int32
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from repro_torch import random as trandom
from repro_torch.core.baselines import choice_cdf, choice_indices
from repro_torch.core.feature_engine import BatchedDecoder
from repro_torch.tabular import vgm as vgm_mod
from repro_torch.tabular.schema import TableSchema


class TableCodec:
    """Mode-specific normalization for continuous columns (one VGM each)
    plus one-hot categories."""

    def __init__(self, schema: TableSchema, n_modes: int = 5,
                 vgms: Optional[List[vgm_mod.VGMParams]] = None):
        self.schema = schema
        self.n_modes = n_modes
        self.vgms: List[vgm_mod.VGMParams] = list(vgms or [])

    def fit(self, cont: np.ndarray, cat: np.ndarray) -> "TableCodec":
        self.vgms = [vgm_mod.fit_vgm(cont[:, j], self.n_modes, seed=j)
                     for j in range(self.schema.n_cont)]
        return self

    @property
    def cont_widths(self) -> List[int]:
        return [1 + self.n_modes] * self.schema.n_cont

    @property
    def enc_dim(self) -> int:
        return sum(self.cont_widths) + sum(self.schema.cat_cards)

    def encode(self, cont: np.ndarray, cat: np.ndarray) -> np.ndarray:
        """(N, enc_dim) float32: per continuous column [α, mode one-hot],
        then each categorical column's one-hot."""
        parts = []
        for j, p in enumerate(self.vgms):
            mode, alpha = vgm_mod.transform(p, cont[:, j])
            onehot = np.eye(self.n_modes, dtype=np.float32)[mode]
            parts.append(np.concatenate([alpha[:, None], onehot], 1))
        for j, card in enumerate(self.schema.cat_cards):
            parts.append(np.eye(card, dtype=np.float32)[cat[:, j]])
        return np.concatenate(parts, 1) if parts else np.zeros((len(cont), 0))

    def decode(self, raw: np.ndarray, rng: np.random.Generator
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Host decode of activated generator output ``raw`` (α in
        [-1, 1], mode / category probabilities): one inverse-CDF draw per
        row and group (:func:`_sample_rows`), in column order."""
        n = raw.shape[0]
        cont = np.zeros((n, self.schema.n_cont), np.float32)
        cat = np.zeros((n, self.schema.n_cat), np.int32)
        off = 0
        for j, p in enumerate(self.vgms):
            alpha = raw[:, off]
            probs = raw[:, off + 1: off + 1 + self.n_modes]
            probs = np.where(p.active[None], np.maximum(probs, 1e-9), 0)
            mode = _sample_rows(probs, rng)
            cont[:, j] = _inverse(p, mode, np.clip(alpha, -1, 1))
            off += 1 + self.n_modes
        for j, card in enumerate(self.schema.cat_cards):
            probs = np.maximum(raw[:, off: off + card], 1e-9)
            cat[:, j] = _sample_rows(probs, rng)
            off += card
        return cont, cat

    def decode_reference(self, raw: np.ndarray, rng: np.random.Generator
                         ) -> Tuple[np.ndarray, np.ndarray]:
        """The per-row decode (an ``rng.choice`` a row for modes, one
        ``rng.random`` column for categories): the baseline the vectorized
        decode and the engine are held against; not a hot path."""
        n = raw.shape[0]
        cont = np.zeros((n, self.schema.n_cont), np.float32)
        cat = np.zeros((n, self.schema.n_cat), np.int32)
        off = 0
        for j, p in enumerate(self.vgms):
            alpha = raw[:, off]
            probs = raw[:, off + 1: off + 1 + self.n_modes]
            probs = np.where(p.active[None], np.maximum(probs, 1e-9), 0)
            probs = probs / probs.sum(1, keepdims=True)
            mode = np.array([rng.choice(self.n_modes, p=pr) for pr in probs])
            cont[:, j] = _inverse(p, mode, np.clip(alpha, -1, 1))
            off += 1 + self.n_modes
        for j, card in enumerate(self.schema.cat_cards):
            probs = np.maximum(raw[:, off: off + card], 1e-9)
            probs = probs / probs.sum(1, keepdims=True)
            cdf = probs.cumsum(1)
            u = rng.random((n, 1))
            cat[:, j] = np.minimum((u > cdf).sum(1), card - 1)
            off += card
        return cont, cat

    def batched(self, batch: int = 1 << 16, device="cuda") -> BatchedDecoder:
        return BatchedDecoder(self.schema, self.vgms, self.n_modes, batch,
                              device)


def _inverse(p: vgm_mod.VGMParams, mode: np.ndarray, alpha: np.ndarray
             ) -> np.ndarray:
    """``vgm.inverse`` on host arrays (float64 arithmetic, float32 out)."""
    return vgm_mod.inverse(p, torch.from_numpy(np.asarray(mode, np.int64)),
                           torch.from_numpy(np.asarray(alpha))).numpy()


def _sample_rows(probs: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """One categorical draw per row, vectorized inverse-CDF.

    ``u`` is scaled by each row's total mass instead of normalizing the
    row, so float rounding in the cumsum can never push the draw past the
    last bin; the final clip guards it all the same."""
    cdf = probs.cumsum(1, dtype=np.float64)
    u = rng.random(len(probs)) * cdf[:, -1]
    k = (u[:, None] >= cdf).sum(1)
    return np.minimum(k, probs.shape[1] - 1)


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

    def forward(self, x: torch.Tensor, key: Optional[torch.Tensor] = None,
                drop: float = 0.0) -> torch.Tensor:
        """With a ``key`` (training), dropout keeps each unit with
        probability ``1 - drop`` (``random.bernoulli(key, 1 - drop)``) and
        scales the kept ones by ``1 / (1 - drop)``."""
        h = torch.relu(self.fc(self.bn(x)))
        if key is not None and drop > 0:
            keep = trandom.bernoulli(key, 1 - drop, h.shape, h.device)
            scale = torch.tensor(1 - drop, dtype=torch.float32,
                                 device=h.device)
            h = torch.where(keep, h / scale, 0.0)
        return x + h


class MLP(nn.Module):
    """``Dense → ResBlock × n_blocks → Dense``: the generator (``d_z`` in,
    ``enc_dim`` out) and the discriminator (``enc_dim`` in, 1 out)."""

    def __init__(self, d_in: int, d_hid: int, n_blocks: int, d_out: int):
        super().__init__()
        self.inp = Dense(d_in, d_hid)
        self.blocks = nn.ModuleList(ResBlock(d_hid) for _ in range(n_blocks))
        self.out = Dense(d_hid, d_out)

    def forward(self, x: torch.Tensor, key: Optional[torch.Tensor] = None,
                drop: float = 0.0) -> torch.Tensor:
        """Block ``i`` draws its dropout mask with ``fold_in(key, i)``;
        without a key there is no dropout (inference)."""
        h = self.inp(x)
        for i, blk in enumerate(self.blocks):
            h = blk(h, None if key is None else trandom.fold_in(key, i),
                    drop)
        return self.out(h)

    def load_jax_params(self, p: Dict) -> "MLP":
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


def _linear_init(key: torch.Tensor, lin: Dense, device) -> None:
    """``w = normal(split(key)[0], (din, dout)) * float32(1 / sqrt(din))``;
    the bias stays zero from the constructor."""
    k1, _ = trandom.split(key)
    din, dout = lin.w.shape
    w = trandom.normal(k1, (din, dout), device) * torch.tensor(
        1.0 / np.sqrt(din), dtype=torch.float32, device=device)
    lin.w.data = w


def _mlp_init(key: torch.Tensor, din: int, dhid: int, n_blocks: int,
              dout: int, device) -> MLP:
    """An MLP with the reference's initial weights: ``split(key,
    n_blocks + 2)`` gives the input layer, each block's FC and the output
    layer a key each; BatchNorm starts at scale 1, bias 0."""
    mlp = MLP(din, dhid, n_blocks, dout).to(device)
    keys = trandom.split(key, n_blocks + 2)
    _linear_init(keys[0], mlp.inp, device)
    for i, blk in enumerate(mlp.blocks):
        _linear_init(keys[i + 1], blk.fc, device)
    _linear_init(keys[-1], mlp.out, device)
    return mlp


@dataclasses.dataclass
class GANConfig:
    d_z: int = 64
    n_blocks: int = 2
    dropout: float = 0.1
    lr: float = 1e-3
    beta1: float = 0.5
    beta2: float = 0.9
    batch: int = 256
    sample_batch: int = 1 << 16   # rows per inference block


class GANFeatureGenerator:
    """Built unfitted from a schema (then ``fit``), or fitted from a
    ``codec`` and a ``generator`` (``repro_torch.convert``).

    ``block_draw`` may be called from several threads at once (the
    dataset executor's host stage): its decoder cache is filled under a
    lock, and each draw runs under its own ``torch.no_grad``."""

    #: draws run block by block on the device: the dataset manifest pins
    #: the block size and the device class
    engine_batched = True

    #: feature-stream marker recorded in a dataset manifest: the port's
    #: matmul and batch-norm sums agree with the JAX package's only to a
    #: tolerance, so a featured dataset never resumes across packages
    stream_marker = "torch-gan-v1"

    def __init__(self, schema: TableSchema, cfg: Optional[GANConfig] = None,
                 n_modes: int = 5, device="cuda", *,
                 codec: Optional[TableCodec] = None,
                 generator: Optional[MLP] = None):
        self.schema = schema
        self.cfg = cfg if cfg is not None else GANConfig()
        self.codec = codec if codec is not None else TableCodec(schema,
                                                                n_modes)
        self.device = torch.device(device)
        self.generator = None if generator is None else \
            generator.to(self.device)
        self.discriminator: Optional[MLP] = None
        self._losses: List[Tuple[float, float]] = []
        self._decoders: Dict[int, BatchedDecoder] = {}
        self._decoders_lock = threading.Lock()

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

    def fit(self, cont: np.ndarray, cat: np.ndarray, steps: int = 300,
            seed: int = 0) -> "GANFeatureGenerator":
        """Fit the codec on the host, then :meth:`train` on the encoded
        table."""
        self.codec.fit(cont, cat)
        self._decoders = {}          # decoders close over the fitted VGMs
        enc = torch.as_tensor(self.codec.encode(cont, cat),
                              device=self.device)
        return self.train(enc, steps, seed)

    def train(self, enc: torch.Tensor, steps: int, seed: int = 0
              ) -> "GANFeatureGenerator":
        """``steps`` GAN steps from fresh weights on the encoded table
        ``enc`` (N, enc_dim), on the device (see :meth:`trainer`)."""
        step = self.trainer(enc, seed)
        for _ in range(steps):
            step()
        return self

    def trainer(self, enc: torch.Tensor, seed: int = 0):
        """Fresh weights, set as the generator and discriminator, and the
        function that runs the next GAN step on them in place.  Keys:
        ``kg, kd, rng = split(PRNGKey(seed), 3)``; per step ``rng, k =
        split(rng)`` and ``kb, kd_, kg_ = split(k, 3)``; the batch is
        ``randint(kb, (min(batch, N),), 0, N)``.  The D step comes first,
        then the G step against the updated D.  Every 50th step's (D, G)
        losses land in ``_losses``."""
        dev = self.device
        denc = self.codec.enc_dim
        cfg = self.cfg
        kg, kd, rng = trandom.split(trandom.PRNGKey(seed), 3)
        g = _mlp_init(kg, cfg.d_z, max(denc, 32), cfg.n_blocks, denc, dev)
        d = _mlp_init(kd, denc, max(denc, 32), cfg.n_blocks, 1, dev)
        opt_g, opt_d = _Adam(g, cfg, dev), _Adam(d, cfg, dev)
        t = torch.ones((), dtype=torch.float32, device=dev)
        nb = min(cfg.batch, enc.shape[0])
        i = 0
        self.generator, self.discriminator = g, d

        def fake_rows(z, key):
            return self._activate(g(z, key, cfg.dropout))

        def step() -> None:
            nonlocal rng, t, i
            rng, k = trandom.split(rng)
            kb, kd_, kg_ = trandom.split(k, 3)
            idx = trandom.randint(kb, (nb,), 0, enc.shape[0], dev)
            xb = enc[idx.to(torch.int64)]
            # D step: the generator's output is a constant here
            kz, kd1, kd2, kgd = trandom.split(kd_, 4)
            z = trandom.normal(kz, (nb, cfg.d_z), dev)
            with torch.no_grad():
                fake = fake_rows(z, kgd)
            dr = d(xb, kd1, cfg.dropout)[:, 0]
            df = d(fake, kd2, cfg.dropout)[:, 0]
            dl = -(torch.mean(F.logsigmoid(dr))
                   + torch.mean(F.logsigmoid(-df)))
            opt_d.step(torch.autograd.grad(dl, opt_d.params), t)
            # G step against the updated D (non-saturating loss)
            kz, kd1, kgg = trandom.split(kg_, 3)
            z = trandom.normal(kz, (nb, cfg.d_z), dev)
            df = d(fake_rows(z, kgg), kd1, cfg.dropout)[:, 0]
            gl = -torch.mean(F.logsigmoid(df))
            opt_g.step(torch.autograd.grad(gl, opt_g.params), t)
            t = t + 1
            if i % 50 == 0:
                self._losses.append((float(dl.detach()), float(gl.detach())))
            i += 1

        return step

    def block_draw(self, batch: int):
        """The per-block draw ``key → (cont, cat)`` for ``batch`` rows:
        ``kz, kg, kd = split(key, 3)``, generator on ``normal(kz)``,
        activation, Gumbel-max decode with ``kd`` (``kg`` is the dropout
        key, unused at inference)."""
        b = int(batch)
        with self._decoders_lock:
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


class _Adam:
    """Adam as the reference writes it, per parameter::

        m = b1 m + (1 - b1) g;  v = b2 v + (1 - b2) g g
        p = p - lr (m / (1 - b1^t)) / (sqrt(v / (1 - b2^t)) + 1e-8)

    with ``t`` a float32 scalar and the constants rounded to float32
    (``torch.optim.Adam`` orders the bias corrections and epsilon
    differently).  The constants live on the device: CUDA divides by a
    host scalar as a product with its reciprocal."""

    def __init__(self, module: nn.Module, cfg: GANConfig, device):
        self.params = list(module.parameters())
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

        def f32(x):
            return torch.tensor(x, dtype=torch.float32, device=device)

        self.b1, self.b2 = f32(cfg.beta1), f32(cfg.beta2)
        self.one_b1, self.one_b2 = f32(1 - cfg.beta1), f32(1 - cfg.beta2)
        self.lr, self.eps, self.one = f32(cfg.lr), f32(1e-8), f32(1.0)

    @torch.no_grad()
    def step(self, grads, t: torch.Tensor) -> None:
        c1 = self.one - torch.pow(self.b1, t)
        c2 = self.one - torch.pow(self.b2, t)
        for p, m, v, g in zip(self.params, self.m, self.v, grads):
            m.copy_(self.b1 * m + self.one_b1 * g)
            v.copy_(self.b2 * v + self.one_b2 * g * g)
            p.copy_(p - self.lr * (m / c1) / (torch.sqrt(v / c2) + self.eps))


class KDEFeatureGenerator:
    """Per-column Gaussian KDE for continuous columns (Silverman's or a
    fixed bandwidth), empirical frequencies for categorical ones."""

    #: numpy draws, no engine batch: the dataset manifest pins no batch,
    #: device or stream for it
    engine_batched = False

    def __init__(self, schema: TableSchema,
                 bandwidth: Optional[float] = None, device="cuda"):
        self.schema = schema
        self.bandwidth = bandwidth
        self.device = torch.device(device)
        self.cont_data: Optional[np.ndarray] = None
        self.cat_probs: List[np.ndarray] = []

    def fit(self, cont: np.ndarray, cat: np.ndarray, **_
            ) -> "KDEFeatureGenerator":
        """The reference's fit on the host; the table, the bandwidths
        (float64) and the category cdfs are then copied to the device."""
        cont, cat = np.asarray(cont), np.asarray(cat)
        self.cont_data = np.asarray(cont, np.float32)
        n = max(len(cont), 1)
        if self.bandwidth is None:
            # Silverman per column
            self.bw = 1.06 * cont.std(0) * n ** (-1 / 5) + 1e-6
        else:
            self.bw = np.full(self.schema.n_cont, self.bandwidth)
        self.cat_probs = [np.bincount(cat[:, j], minlength=c) / n
                          for j, c in enumerate(self.schema.cat_cards)]
        dev = self.device
        self._data = torch.from_numpy(self.cont_data).to(dev)
        self._bw = torch.from_numpy(np.asarray(self.bw, np.float64)).to(dev)
        self._cdfs = [torch.from_numpy(choice_cdf(p / p.sum())).to(dev)
                      for p in self.cat_probs]
        return self

    def sample(self, rng: np.random.Generator, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """``n`` rows: row indices, then standard normals, then each
        category column's uniforms, drawn by ``rng`` as the reference
        draws them; ``data[idx] + normal · bw`` in float64 on the device,
        cast to float32."""
        dev = self.device
        idx = rng.integers(0, len(self.cont_data), size=n)
        z = rng.normal(0, 1, (n, self.schema.n_cont))
        rows = self._data[torch.from_numpy(idx).to(dev)].to(torch.float64)
        cont = (rows + torch.from_numpy(z).to(dev) * self._bw[None]).to(
            torch.float32)
        if self._cdfs:
            cat = torch.stack([choice_indices(cdf, rng.random(n))
                               for cdf in self._cdfs], 1).to(torch.int32)
        else:
            cat = torch.zeros((n, 0), dtype=torch.int32, device=dev)
        return cont, cat


class RandomFeatureGenerator:
    """Uniform within observed ranges (paper §4.1 'random'): the
    reference's numpy draw on the host, moved to the device."""

    #: numpy draws, no engine batch (see ``KDEFeatureGenerator``)
    engine_batched = False

    def __init__(self, schema: TableSchema, device="cuda"):
        self.schema = schema
        self.device = torch.device(device)

    def fit(self, cont: np.ndarray, cat: np.ndarray, **_
            ) -> "RandomFeatureGenerator":
        cont = np.asarray(cont)
        self.lo = cont.min(0) if cont.size else np.zeros(self.schema.n_cont)
        self.hi = cont.max(0) if cont.size else np.ones(self.schema.n_cont)
        return self

    def sample(self, rng: np.random.Generator, n: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        cont = rng.uniform(self.lo, self.hi,
                           (n, self.schema.n_cont)).astype(np.float32)
        cat = np.stack([rng.integers(0, c, size=n)
                        for c in self.schema.cat_cards], 1).astype(np.int32) \
            if self.schema.cat_cards else np.zeros((n, 0), np.int32)
        return (torch.from_numpy(cont).to(self.device),
                torch.from_numpy(cat).to(self.device))


FEATURE_GENERATORS = {
    "gan": GANFeatureGenerator,
    "kde": KDEFeatureGenerator,
    "random": RandomFeatureGenerator,
}
