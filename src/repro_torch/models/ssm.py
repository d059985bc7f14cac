"""Mamba2 (SSD) blocks: the port of the JAX package's ``models/ssm.py``.

The chunked matmul formulation: within a chunk of ``Q`` tokens the state
contribution is a masked (Q×Q) "attention" product, across chunks a small
recurrent state ``(B, H, P, N)`` is carried by a loop over the chunks.
All decay exponents are ≤ 0 (A = −exp(A_log), dt ≥ 0), so every ``exp``
here lies in [0, 1].

Numerics kept from the reference: the projections and the causal conv
run in the model's dtype, the scan and the states in float32; a ragged
``S`` is padded to a chunk multiple with decay-neutral zeros (dt = 0,
dA = 0); the conv buffers carry the last ``d_conv − 1`` raw (pre-conv)
projections, sliced as the reference slices them (a prompt shorter than
``d_conv − 1`` leaves a shorter buffer: ROADMAP C13).  ``mamba_reference``
is the O(S) recurrent oracle the tests hold the chunked form to.

One departure from the reference, on purpose (ROADMAP C17): the
intra-chunk decays ``exp(cum_i − cum_j)`` are masked to −inf above the
diagonal *before* the ``exp``.  The reference takes the ``exp`` over the
whole chunk and masks after it; at a chunk of 128 the upper triangle
overflows, and its gradient turns non-finite.  The forward is the same.

Under a mesh (DTensor inputs) the chunk scan (``_ssd_scan``) runs in
``local_map`` over each rank's batch rows and SSM heads
(``sharding.split_batch_heads``): DTensor's rules shard the chunk dim and
gather it back for every chunk's ``select``.  So does the causal conv
(``_causal_conv_mesh``), over batch rows and channels.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import split_batch_heads
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import ParamDef


def ssm_dims(cfg) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    H = d_in // s.head_dim
    return d_in, H, s.head_dim, s.d_state


def mamba_defs(cfg, n_layers=None):
    D = cfg.d_model
    d_in, H, Pd, N = ssm_dims(cfg)
    dc = cfg.ssm.d_conv
    L = (n_layers,) if n_layers is not None else ()
    pd = ("layers",) if n_layers is not None else ()
    return {
        "in_z": ParamDef(L + (D, d_in), pd + ("embed", "mlp")),
        "in_x": ParamDef(L + (D, d_in), pd + ("embed", "mlp")),
        "in_b": ParamDef(L + (D, N), pd + ("embed", "ssm_state")),
        "in_c": ParamDef(L + (D, N), pd + ("embed", "ssm_state")),
        "in_dt": ParamDef(L + (D, H), pd + ("embed", "heads")),
        "dt_bias": ParamDef(L + (H,), pd + ("heads",), init="zeros",
                            dtype="float32"),
        "A_log": ParamDef(L + (H,), pd + ("heads",), init="constant",
                          value=0.5, dtype="float32"),
        "D_skip": ParamDef(L + (H,), pd + ("heads",), init="ones",
                           dtype="float32"),
        "conv_x": ParamDef(L + (dc, d_in), pd + ("conv", "mlp"), scale=0.5),
        "conv_b": ParamDef(L + (dc, N), pd + ("conv", "ssm_state"),
                           scale=0.5),
        "conv_c": ParamDef(L + (dc, N), pd + ("conv", "ssm_state"),
                           scale=0.5),
        "norm": ParamDef(L + (d_in,), pd + ("mlp",), init="ones"),
        "out": ParamDef(L + (d_in, D), pd + ("mlp", "embed")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along time.  x: (B, S, C), w: (dc, C).  On
    DTensors in ``local_map`` (each rank its batch rows and channels: the
    conv is per channel), where DTensor's rules for the shifted pads fail
    in some torch versions."""
    if isinstance(x, DTensor):
        return _causal_conv_mesh(x, w)
    dc = w.shape[0]
    S = x.shape[1]
    out = x * w[-1]
    for i in range(1, dc):
        shifted = F.pad(x, (0, 0, i, 0))[:, :S]
        out = out + shifted * w[-1 - i]
    return out


def _causal_conv_mesh(x, w):
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    xp = [p if p.is_shard() and p.dim in (0, 2) else Replicate()
          for p in x.placements]
    wp = [p.__class__(1) if p.is_shard() and p.dim == 2 else Replicate()
          for p in xp]
    wg = [Partial() if p.is_shard() and p.dim == 0 else q
          for p, q in zip(xp, wp)]
    return local_map(_causal_conv, out_placements=xp, in_placements=(xp, wp),
                     in_grad_placements=(xp, wg), device_mesh=mesh,
                     redistribute_inputs=True)(x, w)


def _conv_state_step(buf: torch.Tensor, x_t: torch.Tensor, w: torch.Tensor):
    """Single-token conv with carried buffer.  buf: (B, dc−1, C), x_t:
    (B, 1, C)."""
    full = torch.cat([buf, x_t], dim=1)                  # (B, dc, C)
    y = torch.einsum("bdc,dc->bc", full, w)[:, None]     # (B, 1, C)
    return full[:, 1:], y


class SSMState(NamedTuple):
    state: torch.Tensor        # (B, H, P, N) float32
    conv_x: torch.Tensor       # (B, dc-1, d_in)
    conv_b: torch.Tensor       # (B, dc-1, N)
    conv_c: torch.Tensor       # (B, dc-1, N)


def init_ssm_state(cfg, batch: int, dtype=torch.float32, device="cuda"):
    d_in, H, Pd, N = ssm_dims(cfg)
    dc = cfg.ssm.d_conv
    kw = dict(dtype=dtype, device=device)
    return SSMState(
        state=torch.zeros((batch, H, Pd, N), dtype=torch.float32,
                          device=device),
        conv_x=torch.zeros((batch, dc - 1, d_in), **kw),
        conv_b=torch.zeros((batch, dc - 1, N), **kw),
        conv_c=torch.zeros((batch, dc - 1, N), **kw),
    )


def _project(w, x):
    return (x @ w.in_z, x @ w.in_x, x @ w.in_b, x @ w.in_c, x @ w.in_dt)


def _discretize(w, dt):
    dt = F.softplus(dt.float() + w.dt_bias)
    A = -torch.exp(w.A_log)
    return dt, dt * A                                    # dt (B,S,H), dA <= 0


def _ssd_scan(xh, btc, ctc, dtc, dAc, state):
    """The SSD chunks in order: xh (B, NC, Q, H, Pd), btc/ctc (B, NC, Q,
    N), dtc/dAc (B, NC, Q, H), the carried state (B, H, Pd, N) → (y
    (B, NC, Q, H, Pd), the state after the last chunk)."""
    NC, Q = xh.shape[1], xh.shape[2]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    ys = []
    for c in range(NC):
        xq, bq, cq, dtq, daq = (t[:, c] for t in (xh, btc, ctc, dtc, dAc))
        cum = torch.cumsum(daq, dim=1)                   # (B,Q,H) inclusive
        # intra-chunk
        cb = torch.einsum("bin,bjn->bij", cq, bq)        # (B,Q,Q)
        diff = cum[:, :, None, :] - cum[:, None, :, :]   # (B,Q,Q,H) i,j
        # −inf above the diagonal before the exp (ROADMAP C17)
        att = torch.exp(diff.masked_fill(~mask[None, :, :, None],
                                         float("-inf")))
        att = att * cb[..., None] * dtq[:, None, :, :]   # weight token j
        y = torch.einsum("bijh,bjhp->bihp", att, xq)
        # inter-chunk: the carried state's contribution
        y = y + torch.einsum("bin,bhpn->bihp", cq, state) * \
            torch.exp(cum)[..., None]
        # state update
        decay_all = torch.exp(cum[:, -1])                # (B,H)
        wj = dtq * torch.exp(cum[:, -1:, :] - cum)       # (B,Q,H)
        state = decay_all[..., None, None] * state + torch.einsum(
            "bjh,bjn,bjhp->bhpn", wj, bq, xq)
        ys.append(y)
    return torch.stack(ys, dim=1), state


def mamba_block(w, x: torch.Tensor, cfg,
                ssm_state: Optional[SSMState] = None):
    """Full Mamba2 mixer.  x: (B, S, D) → (y, new_state | None).

    Training and prefill take the chunked SSD scan; with ``ssm_state`` and
    S == 1, the exact single-token step."""
    if ssm_state is not None and x.shape[1] == 1:
        return _mamba_decode(w, x, cfg, ssm_state)
    B, S, D = x.shape
    d_in, H, Pd, N = ssm_dims(cfg)
    Q = min(cfg.ssm.chunk, S)

    z, xin_raw, bt_raw, ct_raw, dt = _project(w, x)
    xin = F.silu(_causal_conv(xin_raw, w.conv_x))
    bt = _causal_conv(bt_raw, w.conv_b)
    ct = _causal_conv(ct_raw, w.conv_c)
    dt, dA = _discretize(w, dt)

    # ragged S: zero-pad to a chunk multiple; dt = 0, dA = 0 on the pad
    # positions make them decay-neutral no-ops for the carried state
    S_real = S
    if S % Q:
        pad = Q - S % Q
        xin, bt, ct, dt, dA = (
            F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad))
            for t in (xin, bt, ct, dt, dA))
        S = S + pad
    NC = S // Q

    xh = xin.reshape(B, NC, Q, H, Pd).float()
    btc = bt.reshape(B, NC, Q, N).float()
    ctc = ct.reshape(B, NC, Q, N).float()
    dtc = dt.reshape(B, NC, Q, H)
    dAc = dA.reshape(B, NC, Q, H)

    state = (ssm_state.state if ssm_state is not None
             else torch.zeros((B, H, Pd, N), dtype=torch.float32,
                              device=x.device))
    scan_in = (xh, btc, ctc, dtc, dAc, state)
    if isinstance(xh, DTensor):
        ys, state = split_batch_heads(
            _ssd_scan, scan_in, ((0, 3), (0, None), (0, None), (0, 3),
                                 (0, 3), (0, 1)), ((0, 3), (0, 1)))
    else:
        ys, state = _ssd_scan(*scan_in)
    y = ys.reshape(B, S, H, Pd)
    y = y + xh.reshape(B, S, H, Pd) * w.D_skip[None, None, :, None]
    y = y.reshape(B, S, d_in)[:, :S_real].to(x.dtype)

    y = rms_norm(y * F.silu(z), w.norm, cfg.norm_eps)
    out = y @ w.out

    new_state = None
    if ssm_state is not None:
        # the conv buffers carry the last dc-1 raw (pre-conv) projections;
        # a negative start counts from the end, as in the reference
        start = S_real - (cfg.ssm.d_conv - 1)
        new_state = SSMState(state=state, conv_x=xin_raw[:, start:],
                             conv_b=bt_raw[:, start:],
                             conv_c=ct_raw[:, start:])
    return out, new_state


def _mamba_decode(w, x: torch.Tensor, cfg, st: SSMState):
    """Single-token recurrent step (exact)."""
    B, S, D = x.shape
    d_in, H, Pd, N = ssm_dims(cfg)
    z, xin_raw, bt_raw, ct_raw, dt = _project(w, x)
    conv_x, xin = _conv_state_step(st.conv_x, xin_raw, w.conv_x)
    conv_b, bt = _conv_state_step(st.conv_b, bt_raw, w.conv_b)
    conv_c, ct = _conv_state_step(st.conv_c, ct_raw, w.conv_c)
    xin = F.silu(xin)
    dt, dA = _discretize(w, dt)

    xh = xin.reshape(B, H, Pd).float()
    b1 = bt.reshape(B, N).float()
    c1 = ct.reshape(B, N).float()
    dt1 = dt.reshape(B, H)
    da1 = dA.reshape(B, H)

    state = torch.exp(da1)[..., None, None] * st.state + torch.einsum(
        "bh,bn,bhp->bhpn", dt1, b1, xh)
    y = torch.einsum("bn,bhpn->bhp", c1, state)
    y = y + xh * w.D_skip[None, :, None]
    y = y.reshape(B, 1, d_in).to(x.dtype)
    y = rms_norm(y * F.silu(z), w.norm, cfg.norm_eps)
    out = y @ w.out
    return out, SSMState(state=state, conv_x=conv_x, conv_b=conv_b,
                         conv_c=conv_c)


def mamba_reference(w, x: torch.Tensor, cfg) -> torch.Tensor:
    """O(S) recurrent oracle (slow; tests only)."""
    B, S, D = x.shape
    st = init_ssm_state(cfg, B, x.dtype, x.device)
    outs = []
    for t in range(S):
        o, st = _mamba_decode(w, x[:, t:t + 1], cfg, st)
        outs.append(o)
    return torch.cat(outs, dim=1)
