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
reference asserts; the port raises ``ValueError`` (ROADMAP C15).

Under a mesh (``moe_ffn(..., mesh)`` on DTensor inputs) both paths run in
``torch.distributed.tensor.experimental.local_map``, since DTensor has no
sharding rule for the dispatch's stable sort, ``searchsorted``,
``scatter_`` and ``index_add_``:

* ``tp``: two maps.  ``_tp_route`` routes each rank's own groups (the
  group dim over the batch's data axes when the groups split evenly
  over them, as the reference's grouping keeps its gathers local),
  replicated over ``model``, and returns the dispatch buffers with the
  routing means (each rank's share, a ``Partial`` sum over the data
  axes: the aux loss is formed from them outside).  ``_tp_experts`` runs
  the E experts on the rank's slice of the ``mlp`` dim (``model``) and
  returns a ``Partial("sum")`` over it; the expert weights are gathered
  over every other axis first (the ``fsdp`` layer all-gather).
* ``ep`` (the reference's ``moe_ffn_ep``): each ``model`` rank owns E/tp
  experts whole, routes its 1/tp slice of the tokens with C from its own
  slice, sends the (E, C, D) dispatch blocks out and back with
  ``all_to_all_single`` and gathers the outputs over ``model``; the aux
  loss is the reference's, over all tokens as one group.  Small decode
  batches fall back to ``tp`` where the reference does.

Numerics kept from the reference: the router's logits are the float32
product of the model-dtype operands (``preferred_element_type``), and
the top-k puts the lower expert first on a tie, as ``jax.lax.top_k``
does (a stable descending sort; ``torch.topk`` promises no order).
"""
from __future__ import annotations

import functools
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


def _route_parts(x_flat: torch.Tensor, gate_w: torch.Tensor, cfg):
    """x_flat: (G, Tg, D) → (expert ids (G, Tg, k) int64, combine gates
    float32, the mean gate of each expert (E,), the mean share of the
    tokens each expert is chosen by (E,))."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    logits = torch.einsum("gtd,de->gte", x_flat.float(), gate_w.float())
    gates_all = torch.softmax(logits, dim=-1)
    top_g, top_e = _top_k(gates_all, k)                          # (G,Tg,k)
    top_g = top_g / top_g.sum(-1, keepdim=True).clamp(min=1e-9)
    me = gates_all.mean(dim=(0, 1))                               # (E,)
    ce = F.one_hot(top_e, E).float().sum(2).mean(dim=(0, 1))
    return top_e, top_g, me, ce


def _aux(me, ce, cfg):
    """The Switch-style load-balance loss from the routing means."""
    return cfg.moe.n_experts * (me * ce).sum()


def _route(x_flat: torch.Tensor, gate_w: torch.Tensor, cfg):
    """x_flat: (G, Tg, D) → (expert ids (G, Tg, k) int64, combine gates
    float32, aux loss)."""
    top_e, top_g, me, ce = _route_parts(x_flat, gate_w, cfg)
    return top_e, top_g, _aux(me, ce, cfg)


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


def _capacity(Tg: int, cfg) -> int:
    return max(1, int(Tg * cfg.moe.top_k * cfg.moe.capacity_factor
                      / cfg.moe.n_experts))


def _n_groups(T: int, cfg) -> int:
    Gr = min(cfg.moe.n_groups, T)
    if T % Gr:
        raise ValueError(f"{T} tokens do not split into {Gr} groups")
    return Gr


def _tp_route(x: torch.Tensor, gate_w: torch.Tensor, cfg, groups: int):
    """Routing of ``x`` (B, S, D) in ``groups`` groups → (buf_tok,
    buf_gate (G, E, C), me, ce)."""
    B, S, D = x.shape
    Tg = B * S // groups
    top_e, top_g, me, ce = _route_parts(x.reshape(groups, Tg, D), gate_w,
                                        cfg)
    buf_tok, buf_gate = _dispatch_buffers(top_e, top_g, Tg,
                                          cfg.moe.n_experts,
                                          _capacity(Tg, cfg))
    return buf_tok, buf_gate, me, ce


def _tp_experts(x: torch.Tensor, buf_tok, buf_gate, w1, w3, w2, cfg):
    """The E experts in order over the dispatch buffers (G, E, C), each
    adding its gated output into a (G, Tg + 1, D) accumulator in the
    model's dtype.  ``w1``/``w3`` (E, D, F), ``w2`` (E, F, D), stacked or
    as lists of E tensors."""
    B, S, D = x.shape
    Gr, E, C = buf_tok.shape
    Tg = B * S // Gr
    xf = x.reshape(Gr, Tg, D)
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
                  for t in (w1, w3, w2))
    for e in range(E):
        idx = rows[e].reshape(-1)
        xg = xrows[idx]                                        # (G·C, D)
        h = F.silu(xg @ w1[e]) * (xg @ w3[e])
        o = h @ w2[e]
        o = o * gates[e].reshape(-1, 1).to(o.dtype)
        acc.index_add_(0, idx, o)
    return acc.reshape(Gr, Tg + 1, D)[:, :Tg].reshape(B, S, D)


def moe_ffn_tp(w, x: torch.Tensor, cfg):
    """The tp path, experts in a loop.  x: (B, S, D) → (out, aux_loss).

    ``w`` holds ``gate`` (D, E) and ``w1``/``w3`` (E, D, F), ``w2``
    (E, F, D), stacked or as lists of E tensors."""
    B, S, _ = x.shape
    Gr = _n_groups(B * S, cfg)
    buf_tok, buf_gate, me, ce = _tp_route(x, w.gate, cfg, Gr)
    out = _tp_experts(x, buf_tok, buf_gate, w.w1, w.w3, w.w2, cfg)
    return out, _aux(me, ce, cfg)


# ---------------------------------------------------------------------------
# Under a mesh
# ---------------------------------------------------------------------------

def _stacked_experts(w):
    return tuple(torch.stack(list(t)) if isinstance(t, (list, tuple)) else t
                 for t in (w.w1, w.w3, w.w2))


def _dp_axes(sizes) -> tuple:
    return tuple(a for a in ("pod", "data") if a in sizes)


def _axes_size(sizes, axes) -> int:
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def moe_ffn_tp_mesh(w, x, cfg, mesh):
    """The tp path on DTensors (see the module docstring)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import sharding as shd
    sizes = shd.axis_sizes(mesh)
    pl = functools.partial(shd.mesh_placements, mesh)
    B, S, D = x.shape
    Gr = _n_groups(B * S, cfg)
    rules = shd.get_rules() or shd.make_rules(cfg, mesh)
    # the groups over the batch's axes where groups and batch split evenly
    bax = shd.spec_axes((shd.resolve_spec(("batch",), (B,), rules, mesh)
                         or (None,))[0])
    nb = _axes_size(sizes, bax)
    if Gr % nb:
        bax, nb = (), 1
    w1, w3, w2 = _stacked_experts(w)
    # the experts' mlp dim over 'model' where the rules put it there
    mlp = "model" if ("model" not in bax and shd.resolve_spec(
        ("experts", "embed", "mlp"), w1.shape, rules, mesh)[2:3]
        == ("model",)) else None
    on_b = {a: 0 for a in bax}
    x_in = pl(on_b)
    rep = pl({})
    def route_local(xl, g):
        bt, bg, me, ce = _tp_route(xl, g, cfg, Gr // nb)
        return bt, bg, me / nb, ce / nb

    # the routing means as sums of each rank's share: a Partial("avg")
    # output would take the whole gradient on every rank
    route = local_map(
        route_local,
        out_placements=(x_in, x_in, pl({}, bax),
                        pl({}, bax)),
        in_placements=(x_in, rep),
        in_grad_placements=(x_in, pl({}, bax)),
        device_mesh=mesh, redistribute_inputs=True)
    buf_tok, buf_gate, me, ce = route(x, w.gate)
    m_part = (mlp,) if mlp else ()
    w13 = pl({mlp: 2} if mlp else {})
    w2p = pl({mlp: 1} if mlp else {})
    experts = local_map(
        lambda xl, bt, bg, a, b, c: _tp_experts(xl, bt, bg, a, b, c, cfg),
        out_placements=pl(on_b, m_part),
        in_placements=(x_in, x_in, x_in, w13, w13, w2p),
        in_grad_placements=(pl(on_b, m_part), x_in,
                            pl(on_b, m_part),
                            pl({mlp: 2} if mlp else {}, bax),
                            pl({mlp: 2} if mlp else {}, bax),
                            pl({mlp: 1} if mlp else {}, bax)),
        device_mesh=mesh, redistribute_inputs=True)
    out = experts(x, buf_tok, buf_gate, w1, w3, w2)
    return out, _aux(me, ce, cfg)


def _ep_local(xl, gate_w, w1, w3, w2, cfg, group, tp: int, midx: int):
    """The reference's ``local_moe`` on one rank: (Bl, S, D) replicated
    over the ``model`` group of ``tp`` ranks, this rank its ``midx``."""
    from torch.distributed import _functional_collectives as funcol
    Bl, S, D = xl.shape
    E = cfg.moe.n_experts
    E_local = E // tp
    Tm = Bl * S // tp
    xt = xl.reshape(Bl * S, D)[midx * Tm:(midx + 1) * Tm]       # (Tm, D)
    top_e, top_g, _, _ = _route_parts(xt[None], gate_w, cfg)
    C = _capacity(Tm, cfg)
    buf_tok, buf_gate = _dispatch_buffers(top_e, top_g, Tm, E, C)
    buf_tok, buf_gate = buf_tok[0], buf_gate[0]                  # (E, C)
    xpad = torch.cat([xt, xt.new_zeros(1, D)], dim=0)
    xsend = xpad[buf_tok.long()]                                 # (E, C, D)
    # every rank sends the C-slot blocks of the experts each peer owns
    # and receives (tp, E_local, C, D): the tokens for its own experts
    xrecv = funcol.all_to_all_single_autograd(
        xsend.contiguous(), None, None, group)
    xr = xrecv.reshape(tp, E_local, C, D).transpose(0, 1).reshape(
        E_local, tp * C, D)
    h = F.silu(torch.einsum("ecd,edf->ecf", xr, w1))
    h = h * torch.einsum("ecd,edf->ecf", xr, w3)
    o = torch.einsum("ecf,efd->ecd", h, w2)                      # (El,tpC,D)
    o = o.reshape(E_local, tp, C, D).transpose(0, 1).contiguous()
    oback = funcol.all_to_all_single_autograd(o, None, None, group)
    oback = oback.reshape(E, C, D) * buf_gate[..., None].to(o.dtype)
    out = xl.new_zeros(Tm + 1, D)
    out = out.index_add(0, buf_tok.reshape(-1).long(),
                        oback.reshape(-1, D).to(xl.dtype))[:Tm]
    # the full token set back across the model ranks
    gather = getattr(funcol, "all_gather_single_autograd",
                     funcol.all_gather_tensor_autograd)
    out = gather(out, 0, group)                                  # (Tl, D)
    return out.reshape(Bl, S, D)


def moe_ffn_ep(w, x, cfg, mesh):
    """The ep path on DTensors (see the module docstring)."""
    from torch.distributed.tensor.experimental import local_map
    from repro_torch.distributed import sharding as shd
    sizes = shd.axis_sizes(mesh)
    pl = functools.partial(shd.mesh_placements, mesh)
    B, S, D = x.shape
    E = cfg.moe.n_experts
    tp = sizes["model"]
    if E % tp:
        raise ValueError(f"{E} experts do not split over {tp} model ranks")
    dp_axes = _dp_axes(sizes)
    bax = dp_axes if B % _axes_size(sizes, dp_axes) == 0 else ()
    w1, w3, w2 = _stacked_experts(w)
    group = mesh.get_group("model")
    midx = mesh.get_local_rank("model")
    x_in = pl({a: 0 for a in bax})
    own = pl({"model": 0})
    fn = local_map(
        lambda xl, g, a, b, c: _ep_local(xl, g, a, b, c, cfg, group, tp,
                                         midx),
        out_placements=x_in,
        in_placements=(x_in, pl({}), own, own, own),
        in_grad_placements=(pl({a: 0 for a in bax}, ("model",)),
                            pl({}, bax + ("model",)),
                            pl({"model": 0}, bax),
                            pl({"model": 0}, bax),
                            pl({"model": 0}, bax)),
        device_mesh=mesh, redistribute_inputs=True)
    out = fn(x, w.gate, w1, w3, w2)
    # the aux loss over every token as one group, as the reference's
    nb = _axes_size(sizes, bax)

    def stats_local(xl, g):
        _, _, me, ce = _route_parts(xl.reshape(1, -1, D), g, cfg)
        return me / nb, ce / nb

    stats = local_map(
        stats_local,
        out_placements=(pl({}, bax), pl({}, bax)),
        in_placements=(x_in, pl({})),
        in_grad_placements=(x_in, pl({}, bax)),
        device_mesh=mesh, redistribute_inputs=True)
    me, ce = stats(x, w.gate)
    return out, _aux(me, ce, cfg)


def moe_ffn(w, x: torch.Tensor, cfg, mesh=None):
    """The MoE FFN: without a mesh the tp path, as the reference's
    choice; under a mesh the ep path where ``cfg.moe_path == "ep"`` and
    every (data, model) rank pair gets a token, else tp on DTensors."""
    if mesh is None:
        return moe_ffn_tp(w, x, cfg)
    from repro_torch.distributed import sharding as shd
    if cfg.moe_path == "ep":
        sizes = shd.axis_sizes(mesh)
        B, S, _ = x.shape
        dp = _axes_size(sizes, _dp_axes(sizes))
        tp = sizes.get("model", 1)
        # ep needs ≥ 1 token per (data, model) rank pair; small decode
        # batches fall back to the tp path
        if (B * S) % (dp * tp) == 0 and B % dp == 0:
            return moe_ffn_ep(w, x, cfg, mesh)
    return moe_ffn_tp_mesh(w, x, cfg, mesh)
