"""RWKV6 "Finch" blocks: the port of the JAX package's ``models/rwkv.py``
(data-dependent per-channel decay, attention-free).

The WKV6 recurrence runs in the chunked GLA-style matmul form.  Within a
chunk of ``Q`` tokens the pairwise contribution is

    att[i, j] = sum_K  r_i[K] · exp(cum[i-1] - cum[j]) · k_j[K]   (j < i)
    att[i, i] = sum_K  r_i[K] · u[K] · k_i[K]                      (bonus)

with ``cum`` the inclusive within-chunk cumulative log-decay; across
chunks a state ``(B, H, K, V)`` is carried by a loop over the chunks.

Numerics kept from the reference: the factorization needs
``exp(-cum_j)``, which is unbounded, so the per-step log-decay is clamped
to ``[-DECAY_CLAMP, -1e-6]`` and the chunk kept small enough that
``|cum| <= chunk·DECAY_CLAMP`` stays in float32 range (chunk 32, clamp
2.2: |cum| <= 70.4 < 88).  ``exp(±cum)`` then reaches e^±70 by design, so
the cumulative sum, the clamps and the products are taken in the
reference's order.  The decode path is the exact recurrence;
``wkv_reference`` is the O(S) oracle built from it.  Under a mesh
(DTensor inputs) the chunk scan (``_wkv_scan``) and the decode step
(``_wkv_step``) run in ``local_map`` over each rank's batch rows and
heads (``sharding.split_batch_heads``), the projections through
``layers.head_proj``/``head_unproj``, the channel mix's FFN as
Megatron's MLP (``_channel_ffn_mesh``).  Token-shift uses
static learned mixing, as in the reference.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import split_batch_heads

from repro_torch.models.layers import (group_norm_heads, head_proj,
                                       head_unproj)
from repro_torch.models.params import ParamDef

DECAY_CLAMP = 2.2


def rwkv_dims(cfg):
    K = cfg.rwkv.head_dim
    H = cfg.d_model // K
    return H, K


def rwkv_defs(cfg, n_layers=None):
    D, F_ = cfg.d_model, cfg.d_ff
    H, K = rwkv_dims(cfg)
    R = cfg.rwkv.decay_lora
    L = (n_layers,) if n_layers is not None else ()
    pd = ("layers",) if n_layers is not None else ()

    def mix():
        return ParamDef(L + (D,), pd + ("embed",), init="constant",
                        value=0.5)

    return {
        # time-mix (WKV) block
        "mu_r": mix(), "mu_k": mix(), "mu_v": mix(), "mu_w": mix(),
        "mu_g": mix(),
        "wr": ParamDef(L + (D, H, K), pd + ("embed", "heads", "head_dim")),
        "wk": ParamDef(L + (D, H, K), pd + ("embed", "heads", "head_dim")),
        "wv": ParamDef(L + (D, H, K), pd + ("embed", "heads", "head_dim")),
        "wg": ParamDef(L + (D, H, K), pd + ("embed", "heads", "head_dim")),
        "w0": ParamDef(L + (H, K), pd + ("heads", "head_dim"),
                       init="constant", value=-0.6, dtype="float32"),
        "wl1": ParamDef(L + (D, R), pd + ("embed", "lora"), scale=0.01),
        "wl2": ParamDef(L + (R, H, K), pd + ("lora", "heads", "head_dim"),
                        scale=0.01),
        "u": ParamDef(L + (H, K), pd + ("heads", "head_dim"),
                      init="constant", value=0.5, dtype="float32"),
        "ln_x": ParamDef(L + (D,), pd + ("embed",), init="ones"),
        "wo": ParamDef(L + (H, K, D), pd + ("heads", "head_dim", "embed")),
        # channel-mix block
        "mu_ck": mix(), "mu_cr": mix(),
        "ck": ParamDef(L + (D, F_), pd + ("embed", "mlp")),
        "cv": ParamDef(L + (F_, D), pd + ("mlp", "embed")),
        "cr": ParamDef(L + (D, D), pd + ("embed", "embed_out")),
    }


class RWKVState(NamedTuple):
    wkv: torch.Tensor       # (B, H, K, V) float32
    shift_tm: torch.Tensor  # (B, D) last token entering time-mix
    shift_cm: torch.Tensor  # (B, D) last token entering channel-mix


def init_rwkv_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    H, K = rwkv_dims(cfg)
    D = cfg.d_model
    return RWKVState(
        wkv=torch.zeros((batch, H, K, K), dtype=torch.float32,
                        device=device),
        shift_tm=torch.zeros((batch, D), dtype=dtype, device=device),
        shift_cm=torch.zeros((batch, D), dtype=dtype, device=device),
    )


def _shift(x: torch.Tensor, last: Optional[torch.Tensor] = None
           ) -> torch.Tensor:
    """x_{t-1} along time; ``last`` seeds t = 0 (decode continuity)."""
    first = (x.new_zeros(x.shape[0], 1, x.shape[2]) if last is None
             else last[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _log_decay(w, xw: torch.Tensor) -> torch.Tensor:
    """Data-dependent per-channel log-decay (B, S, H, K), clamped to
    ``[-DECAY_CLAMP, -1e-6]``."""
    lora = xw @ w.wl1
    lora = torch.einsum("bsr,rhk->bshk", torch.tanh(lora), w.wl2)
    logw = -torch.exp(torch.clamp(w.w0[None, None] + lora.float(), -20.0,
                                  math.log(DECAY_CLAMP)))
    return torch.clamp(logw, -DECAY_CLAMP, -1e-6)


def _time_mix_inputs(w, x: torch.Tensor, last=None):
    prev = _shift(x, last)

    def lerp(mu):
        return x + (prev - x) * mu

    xr, xk, xv, xw, xg = (lerp(m) for m in (w.mu_r, w.mu_k, w.mu_v, w.mu_w,
                                            w.mu_g))
    r = head_proj(xr, w.wr)
    k = head_proj(xk, w.wk)
    v = head_proj(xv, w.wv)
    g = head_proj(xg, w.wg)
    return r, k, v, g, _log_decay(w, xw)


def _wkv_scan(rf, kf, vf, lw, u, st):
    """The WKV6 chunks in order: r/k/v/log-decay (B, NC, Q, H, K), the
    bonus u (H, K), the carried state (B, H, K, K) → (y (B, NC, Q, H, K),
    the state after the last chunk)."""
    NC, Q = rf.shape[1], rf.shape[2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=rf.device),
                      diagonal=-1)                       # strictly lower
    ys = []
    for c in range(NC):
        rq, kq, vq, lq = (t[:, c] for t in (rf, kf, vf, lw))  # (B,Q,H,K)
        cum = torch.cumsum(lq, dim=1)                    # inclusive
        cum_prev = cum - lq                              # cum_{i-1}
        q_dec = rq * torch.exp(cum_prev)
        k_dec = kq * torch.exp(-cum)
        att = torch.einsum("bihk,bjhk->bhij", q_dec, k_dec)
        att = torch.where(mask[None, None], att,
                          torch.zeros((), device=rf.device))
        diag = torch.einsum("bihk,hk,bihk->bhi", rq, u, kq)
        y = torch.einsum("bhij,bjhk->bihk", att, vq)
        y = y + diag[..., None].permute(0, 2, 1, 3) * vq
        # inter-chunk
        y = y + torch.einsum("bihk,bhkv->bihv", q_dec, st)
        # state update
        tot = cum[:, -1]                                 # (B,H,K)
        kup = kq * torch.exp(tot[:, None] - cum)
        st = torch.exp(tot)[..., None] * st + torch.einsum(
            "bjhk,bjhv->bhkv", kup, vq)
        ys.append(y)
    return torch.stack(ys, dim=1), st


def time_mix(w, x: torch.Tensor, cfg, state: Optional[RWKVState] = None):
    """WKV6 time-mixing.  x: (B, S, D) → (y, new_state | None)."""
    B, S, D = x.shape
    H, K = rwkv_dims(cfg)
    if state is not None and S == 1:
        return _time_mix_decode(w, x, cfg, state)

    Q = min(cfg.rwkv.chunk, S)
    last = state.shift_tm if state is not None else None
    r, k, v, g, logw = _time_mix_inputs(w, x, last)

    # ragged S: zero-pad to a chunk multiple; pad positions get k = 0 (no
    # state contribution) and logw = 0 (decay-neutral), so the carried
    # state is exact
    S_real = S
    if S % Q:
        pad = Q - S % Q
        r, k, v, logw = (F.pad(t, (0, 0, 0, 0, 0, pad))
                         for t in (r, k, v, logw))
        S = S + pad
    NC = S // Q

    rf = r.reshape(B, NC, Q, H, K).float()
    kf = k.reshape(B, NC, Q, H, K).float()
    vf = v.reshape(B, NC, Q, H, K).float()
    lw = logw.reshape(B, NC, Q, H, K)

    st = (state.wkv if state is not None
          else torch.zeros((B, H, K, K), dtype=torch.float32,
                           device=x.device))
    scan_in = (rf, kf, vf, lw, w.u, st)
    if isinstance(rf, DTensor):
        ys, st = split_batch_heads(
            _wkv_scan, scan_in, ((0, 3), (0, 3), (0, 3), (0, 3), (None, 0),
                                 (0, 1)), ((0, 3), (0, 1)))
    else:
        ys, st = _wkv_scan(*scan_in)
    y = ys.reshape(B, S, H * K)[:, :S_real].to(x.dtype)

    y = group_norm_heads(y, w.ln_x, H, cfg.norm_eps)
    y = y * F.silu(g.reshape(B, S_real, H * K))
    out = head_unproj(y.reshape(B, S_real, H, K), w.wo)
    new = None
    if state is not None:
        new = state._replace(wkv=st, shift_tm=x[:, -1])
    return out, new


def _wkv_step(r1, k1, v1, lw1, u, wkv):
    """One token of the WKV6 recurrence: r/k/v/log-decay (B, H, K), the
    bonus u (H, K), the state (B, H, K, K) → (y (B, H, K), the state)."""
    kv = torch.einsum("bhk,bhv->bhkv", k1, v1)
    y = torch.einsum("bhk,bhkv->bhv", r1 * u[None], kv)
    y = y + torch.einsum("bhk,bhkv->bhv", r1, wkv)
    return y, torch.exp(lw1)[..., None] * wkv + kv


def _time_mix_decode(w, x: torch.Tensor, cfg, state: RWKVState):
    """Exact single-token recurrence."""
    B, S, D = x.shape
    H, K = rwkv_dims(cfg)
    r, k, v, g, logw = _time_mix_inputs(w, x, state.shift_tm)
    step_in = (r[:, 0].float(), k[:, 0].float(), v[:, 0].float(),
               logw[:, 0], w.u, state.wkv)                # (B,H,K), ...
    if isinstance(step_in[0], DTensor):
        y, st = split_batch_heads(_wkv_step, step_in,
                                  ((0, 1),) * 4 + ((None, 0), (0, 1)),
                                  ((0, 1), (0, 1)))
    else:
        y, st = _wkv_step(*step_in)
    y = y.reshape(B, 1, H * K).to(x.dtype)
    y = group_norm_heads(y, w.ln_x, H, cfg.norm_eps)
    y = y * F.silu(g.reshape(B, 1, H * K))
    out = head_unproj(y.reshape(B, 1, H, K), w.wo)
    return out, state._replace(wkv=st, shift_tm=x[:, -1])


def channel_mix(w, x: torch.Tensor, state: Optional[RWKVState] = None):
    last = state.shift_cm if state is not None else None
    prev = _shift(x, last)
    xk = x + (prev - x) * w.mu_ck
    xr = x + (prev - x) * w.mu_cr
    if isinstance(w.ck, DTensor):
        out = _channel_ffn_mesh(xk, xr, w.ck, w.cv, w.cr)
    else:
        out = _channel_ffn(xk, xr, w.ck, w.cv, w.cr)
    new = state._replace(shift_cm=x[:, -1]) if state is not None else None
    return out, new


def _channel_ffn(xk, xr, ck, cv, cr):
    kk = torch.square(torch.relu(xk @ ck))
    return torch.sigmoid(xr @ cr) * (kk @ cv)


def _channel_ffn_mesh(xk, xr, ck, cv, cr):
    """The channel mix's FFN on DTensors in ``local_map``, as Megatron's
    MLP: ``ck`` split along its output and ``cv`` along its input where
    the rules split ``mlp``, ``cr`` whole, each rank its batch rows, the
    output a ``Partial`` sum over the ranks of the split (the receptance
    gate multiplies each rank's part)."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.models.layers import _batch_placements
    mesh = ck.device_mesh
    xp = _batch_placements(xk)
    split = [p.is_shard() and p.dim == 1 for p in ck.placements]
    ckp = [Shard(1) if s_ else Replicate() for s_ in split]
    cvp = [Shard(0) if s_ else Replicate() for s_ in split]
    rep = [Replicate()] * mesh.ndim
    out = [Partial() if s_ else p for s_, p in zip(split, xp)]

    def wgrad(pl, partial_split=False):
        return [Partial() if p.is_shard() or (s_ and partial_split) else q
                for p, q, s_ in zip(xp, pl, split)]

    return local_map(_channel_ffn, out_placements=out,
                     in_placements=(xp, xp, ckp, cvp, rep),
                     in_grad_placements=(out, out, wgrad(ckp), wgrad(cvp),
                                         wgrad(rep, True)),
                     device_mesh=mesh, redistribute_inputs=True)(
        xk, xr, ck, cv, cr)


def wkv_reference(w, x: torch.Tensor, cfg) -> torch.Tensor:
    """O(S) recurrent oracle for the time-mix block (tests only)."""
    B, S, D = x.shape
    st = init_rwkv_state(cfg, B, x.dtype, x.device)
    outs = []
    for t in range(S):
        o, st = _time_mix_decode(w, x[:, t:t + 1], cfg, st)
        outs.append(o)
    return torch.cat(outs, dim=1)
