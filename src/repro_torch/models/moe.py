"""Mixture-of-Experts FFN: the port of the JAX package's ``models/moe.py``
(its ``tp`` path).

Token-choice top-k routing with grouped local capacity: tokens are
reshaped to ``(n_groups, Tg)``, each group dispatches up to ``C`` tokens
to each expert by a sorted scatter (``_dispatch_buffers``), and the
experts run one after another, each adding its gated output into a
``(G, Tg + 1, D)`` accumulator in the model's dtype, in expert order
0…E−1.  Dropped slots point at the padding row ``Tg``, which is thrown
away.  Routing is softmax-over-top-k (qwen3 style; top-1 is switch
routing, llama4-scout's) with the Switch-style load-balance loss.

The tokens must split into ``min(n_groups, T)`` groups, as the
reference asserts; the port raises ``ValueError`` (ROADMAP C15).  The
reference's ``ep`` path (``shard_map`` all-to-all over a mesh's
``model`` axis) waits for the sharding port; without a mesh the reference
itself takes ``tp``, as ``moe_ffn`` does here.

Numerics kept from the reference: the router's logits are the float32
product of the model-dtype operands (``preferred_element_type``), and
the top-k puts the lower expert first on a tie, as ``jax.lax.top_k``
does (a stable descending sort; ``torch.topk`` promises no order).
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.models.params import ParamDef


def moe_defs(cfg, n_layers=None, stacked: bool = True):
    """Expert weights: stacked ``(E, D, F)`` (``(L, E, D, F)`` with
    ``n_layers``), or a list of E per-expert defs (``scan_layers=False``)."""
    D, F_, E = cfg.d_model, cfg.d_ff, cfg.moe.n_experts
    L = (n_layers,) if n_layers is not None else ()
    pd = ("layers",) if n_layers is not None else ()
    out = {"gate": ParamDef(L + (D, E), pd + ("embed", None), scale=0.02)}
    if stacked:
        out.update(
            w1=ParamDef(L + (E, D, F_), pd + ("experts", "embed", "mlp")),
            w3=ParamDef(L + (E, D, F_), pd + ("experts", "embed", "mlp")),
            w2=ParamDef(L + (E, F_, D), pd + ("experts", "mlp", "embed")),
        )
    else:
        if n_layers is not None:
            raise ValueError("per-expert defs are per layer (n_layers=None)")
        out.update(
            w1=[ParamDef((D, F_), ("embed", "mlp")) for _ in range(E)],
            w3=[ParamDef((D, F_), ("embed", "mlp")) for _ in range(E)],
            w2=[ParamDef((F_, D), ("mlp", "embed")) for _ in range(E)],
        )
    return out


def _top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``jax.lax.top_k``: the k largest along the last dim, the lower
    index first on a tie."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(x_flat: torch.Tensor, gate_w: torch.Tensor, cfg):
    """x_flat: (G, Tg, D) → (expert ids (G, Tg, k) int64, combine gates
    float32, aux loss)."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    logits = torch.einsum("gtd,de->gte", x_flat.float(), gate_w.float())
    gates_all = torch.softmax(logits, dim=-1)
    top_g, top_e = _top_k(gates_all, k)                          # (G,Tg,k)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp(min=1e-9)
    # Switch-style load-balance loss
    me = gates_all.mean(dim=(0, 1))                               # (E,)
    ce = F.one_hot(top_e, E).float().sum(2).mean(dim=(0, 1))
    aux = E * (me * ce).sum()
    return top_e, top_g, aux


def _dispatch_buffers(top_e: torch.Tensor, top_g: torch.Tensor, Tg: int,
                      E: int, C: int):
    """Sorted-scatter dispatch: per expert, up to C token slots per group.

    Returns (buf_tok (G, E, C) int32 indices into Tg [Tg == dropped],
             buf_gate (G, E, C) float32)."""
    G, T, k = top_e.shape
    dev = top_e.device
    flat_e = top_e.reshape(G, T * k).long()
    flat_t = torch.arange(T, dtype=torch.int32, device=dev)[:, None]
    flat_t = flat_t.expand(T, k).reshape(1, T * k).expand(G, T * k)
    flat_g = top_g.reshape(G, T * k)

    order = torch.argsort(flat_e, dim=-1, stable=True)
    se = flat_e.gather(-1, order)
    st = flat_t.gather(-1, order)
    sg = flat_g.gather(-1, order)

    # position within the expert's segment
    experts = torch.arange(E, device=dev)[None].expand(G, E).contiguous()
    starts = torch.searchsorted(se, experts, side="left")
    pos = torch.arange(T * k, device=dev)[None] - starts.gather(-1, se)
    keep = pos < C
    dest = torch.where(keep, se * C + pos, E * C)     # E*C: the drop slot

    buf_tok = torch.full((G, E * C + 1), Tg, dtype=torch.int32, device=dev)
    buf_gate = torch.zeros((G, E * C + 1), dtype=torch.float32, device=dev)
    buf_tok.scatter_(1, dest, st)
    buf_gate.scatter_(1, dest, sg.float())
    return (buf_tok[:, :E * C].reshape(G, E, C),
            buf_gate[:, :E * C].reshape(G, E, C))


def moe_ffn_tp(w, x: torch.Tensor, cfg):
    """The tp path, experts in a loop.  x: (B, S, D) → (out, aux_loss).

    ``w`` holds ``gate`` (D, E) and ``w1``/``w3`` (E, D, F), ``w2``
    (E, F, D), stacked or as lists of E tensors."""
    B, S, D = x.shape
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    T = B * S
    Gr = min(cfg.moe.n_groups, T)
    if T % Gr:
        raise ValueError(f"{T} tokens do not split into {Gr} groups")
    Tg = T // Gr
    C = max(1, int(Tg * k * cfg.moe.capacity_factor / E))

    xf = x.reshape(Gr, Tg, D)
    top_e, top_g, aux = _route(xf, w.gate, cfg)
    buf_tok, buf_gate = _dispatch_buffers(top_e, top_g, Tg, E, C)

    # a zero row per group, so dropped slots (index Tg) gather zeros
    xpad = torch.cat([xf, xf.new_zeros(Gr, 1, D)], dim=1)
    # rows of the flattened (G·(Tg + 1), D) accumulator each slot adds to
    base = torch.arange(Gr, device=x.device)[:, None, None] * (Tg + 1)
    rows = (buf_tok.long() + base).transpose(0, 1)            # (E, G, C)
    gates = buf_gate.transpose(0, 1)
    acc = x.new_zeros(Gr * (Tg + 1), D)
    xrows = xpad.reshape(Gr * (Tg + 1), D)
    # one view per expert by a single ``unbind``: its backward stacks the
    # experts' gradients once, where indexing the stacked leaf per expert
    # would add a zero-filled (E, D, F) gradient for every expert (a list
    # of per-expert leaves stays as it is)
    w1, w3, w2 = (t.unbind(0) if isinstance(t, torch.Tensor) else t
                  for t in (w.w1, w.w3, w.w2))
    for e in range(E):
        idx = rows[e].reshape(-1)
        xg = xrows[idx]                                        # (G·C, D)
        h = F.silu(xg @ w1[e]) * (xg @ w3[e])
        o = h @ w2[e]
        o = o * gates[e].reshape(-1, 1).to(o.dtype)
        acc.index_add_(0, idx, o)
    return acc.reshape(Gr, Tg + 1, D)[:, :Tg].reshape(B, S, D), aux


def moe_ffn(w, x: torch.Tensor, cfg):
    """The MoE FFN: the tp path (the reference's choice without a mesh)."""
    return moe_ffn_tp(w, x, cfg)
