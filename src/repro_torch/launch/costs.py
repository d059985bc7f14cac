"""Cost extraction for the roofline: the port of the JAX package's
``launch/costs.py``.

The reference lowers each cell with XLA and fights ``cost_analysis()``'s
habit of counting a ``while`` body once: it compiles a probe with every
scan unrolled at depth 1 and 2 and extrapolates, and parses the
collectives out of the optimized HLO.  The port has no HLO.  It runs the
cell's eager step on ``meta`` tensors — DTensors over the placeholder
process group of ``launch.mesh.fake_process_group``, so every rank's
shapes, placements and collectives are rank 0's real ones and nothing is
computed — under one ``TorchDispatchMode`` (``CostProbe``) that counts:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (FlopCounterMode's
  own table): ``global_flops`` as FlopCounterMode counts the step (each
  DTensor op once at its global shapes, and the ops on plain tensors),
  ``flops`` on the local tensors every op runs on rank 0 (replicated work
  included).  The table counts matrix products and convolutions only;
* **bytes**: every local op's input and output bytes (views, factory ops
  and collectives left out).  Eager runs each op unfused, so this is an
  upper bound on what a fused step moves;
* **collectives**: each ``_c10d_functional`` op's kind, group size and
  payload (its output bytes, the reference's convention), caught as
  ``CommDebugMode`` catches them (DTensor's local functional ops) but
  with their bytes, with link
  bytes by the reference's model (``link_bytes``: all-reduce 2·(n−1)/n
  of the payload, the rest (n−1)/n), n each collective's own group's
  size (the reference takes the ``model`` axis's for all);
* **peak live bytes** of the tensors the step makes, through a finalizer
  on each new storage: a train step's gradients and update apart
  (``CostProbe.mark``), each extrapolated in depth, the larger taken.

Python loops over layers, experts and chunks run as they are, so no
``while`` body is undercounted; the depth probe stays for time only, and
extrapolates with the reference's formulas (``probe_combine``): ``F(L) =
F(1) + (L−1)·[F(2) − F(1)]``; the hybrid ``F(L) = F(1) + (L−1)·ΔM +
(⌈L/ae⌉−1)·ΔA``, its ΔA from L = 2 with the shared block before every
layer (the reference's from L = ae + 1, a longer run); encdec ``F(Le,
Ld) = F(1,1) + (Le−1)·ΔE + (Ld−1)·ΔD``, the step's peak live bytes with
them.  A train step of M microbatches is probed at each depth point from
its microbatch's batch run as two microbatches and as three, ``F(M) =
F(2) + (M−2)·[F(3) − F(2)]`` (``probe_plan``), where the reference
probes one microbatch of the whole batch.  The runs are independent:
``launch.dryrun --jobs`` spreads them over processes.

``matmul_param_count`` and ``model_flops`` are the reference's arithmetic.
"""
from __future__ import annotations

import dataclasses
import math
import weakref
from collections import Counter
from typing import Any, Dict, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: the reference's names of the collective kinds, by the functional op
_KINDS = {"all_reduce": "all-reduce", "all_gather_into_tensor": "all-gather",
          "reduce_scatter_tensor": "reduce-scatter",
          "all_to_all_single": "all-to-all", "broadcast": "broadcast",
          # DTensor's Shard(i) → Shard(j) on one mesh dim
          "shard_dim_alltoall": "all-to-all"}


def link_bytes(kind: str, payload: float, n: int) -> float:
    """Bytes a device sends over links for one collective of ``payload``
    bytes over ``n`` devices: 2·(n−1)/n of it for an all-reduce, (n−1)/n
    for the others."""
    frac = (n - 1) / n
    return 2 * payload * frac if kind == "all-reduce" else payload * frac


def summarize_collectives(records) -> Dict[str, Any]:
    """``records``: (kind, payload bytes, group size) of each collective →
    the reference's ``parse_collectives`` fields: counts, payload bytes by
    kind, total payload and modeled link bytes."""
    counts: Counter = Counter()
    by_kind: Counter = Counter()
    payload = 0
    link = 0.0
    for kind, nbytes, n in records:
        counts[kind] += 1
        by_kind[kind] += nbytes
        payload += nbytes
        link += link_bytes(kind, nbytes, n)
    return {"counts": dict(counts), "bytes_by_kind": dict(by_kind),
            "payload_bytes": int(payload), "link_bytes": float(link)}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(x) -> list:
    """The tensors in ``x`` (nested tuples, lists and dicts)."""
    out, stack = [], [x]
    while stack:
        y = stack.pop()
        if isinstance(y, torch.Tensor):
            out.append(y)
        elif isinstance(y, (list, tuple)):
            stack.extend(y)
        elif isinstance(y, dict):
            stack.extend(y.values())
    return out


def _fake(tensors) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return any(isinstance(t, FakeTensor) for t in tensors)


def _group_size(args) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = [a for a in args if isinstance(a, str)][-1]
    return _resolve_process_group(name).size()


class _LocalOps(TorchDispatchMode):
    """The local ops a DTensor op runs on a rank, counted into ``probe``
    (entered by ``CostProbe`` around each DTensor op)."""

    def __init__(self, probe):
        super().__init__()
        self.probe = probe

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        self.probe._local(func, args, kwargs, out)
        return out


class CostProbe(TorchDispatchMode):
    """Counts a step's FLOPs, bytes, collectives and peak live bytes (see
    the module docstring).

    ``global_flops`` counts as ``FlopCounterMode`` counts the same step:
    each DTensor op once at its global shapes, and each op the step runs
    on plain tensors (``local_map`` bodies, replicated helpers).  The
    per-rank figures count the local ops: a DTensor op's (``_LocalOps``,
    entered around it) and the plain ones."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self._inner = _LocalOps(self)
        self.global_flops = 0
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.live = 0
        self.peaks = {"step": 0}
        self._phase = "step"

    def mark(self, phase: str) -> None:
        """Start a phase of the step: each phase's peak is kept apart (a
        train step's gradients and its update grow with depth at rates of
        their own, so the step's peak moves from one to the other)."""
        self._phase = phase
        self.peaks[phase] = self.live

    def _free(self, nbytes: int) -> None:
        self.live -= nbytes

    def _track(self, outs) -> None:
        for t in outs:
            st = t.untyped_storage()
            if getattr(st, "_cost_probe_seen", False):
                continue
            st._cost_probe_seen = True
            n = st.nbytes()
            self.live += n
            self.peaks[self._phase] = max(self.peaks[self._phase],
                                          self.live)
            weakref.finalize(st, self._free, n)

    def _count(self, func, args, kwargs, out) -> int:
        packet = func._overloadpacket
        if packet not in self._flops:
            return 0
        return self._flops[packet](*args, **kwargs, out_val=out)

    def _local(self, func, args, kwargs, out) -> None:
        """One rank's op on plain tensors."""
        name = func._overloadpacket.__name__
        outs = _tensors(out)
        ins = _tensors((args, kwargs))
        if name == "wait_tensor" or _fake(outs) or _fake(ins):
            # DTensor infers an op's output on fake tensors of the global
            # shape: no rank runs that
            return
        if name in _KINDS and func.namespace in ("_c10d_functional",
                                                 "c10d_functional",
                                                 "_dtensor"):
            self.collectives.append((_KINDS[name],
                                     sum(_nbytes(t) for t in outs),
                                     _group_size(args)))
        elif not func.is_view and not name.startswith("empty"):
            self.flops += self._count(func, args, kwargs, out)
            self.bytes += sum(_nbytes(t) for t in ins)
            self.bytes += sum(_nbytes(t) for t in outs)
        if not func.is_view:
            self._track(outs)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            self.global_flops += self._count(func, args, kwargs, None)
            with self._inner:
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if not _fake(_tensors((args, out))):
            self.global_flops += self._count(func, args, kwargs, out)
        self._local(func, args, kwargs, out)
        return out

    def result(self) -> Dict[str, Any]:
        return {"flops": float(self.flops),
                "global_flops": float(self.global_flops),
                "bytes": float(self.bytes),
                **{f"peak_{k}": float(v) for k, v in self.peaks.items()},
                "coll": summarize_collectives(self.collectives)}


# ---------------------------------------------------------------------------
# Probe
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CellCosts:
    flops: float               # per-device FLOPs of the step
    global_flops: float        # the step's FLOPs as FlopCounterMode counts
    bytes: float               # per-device bytes of the eager step's ops
    temp_bytes: float          # per-device peak bytes the step allocates
    coll_payload: float        # per-device collective payload bytes
    coll_link: float           # per-device modeled link bytes
    coll_counts: Dict[str, int]
    coll_bytes_by_kind: Dict[str, float]
    probe_points: Dict[str, Any]


def _materialize(abstract, shardings, device):
    """A ``TensorSpec`` tree as DTensors of empty local shards on
    ``device`` (``meta``: nothing allocated) laid out by ``shardings``;
    the cache's ``pos`` as the host int 0."""
    from torch.distributed.tensor import DTensor
    from repro_torch.models.params import TensorSpec
    from repro_torch.training import optimizer as opt_mod
    if isinstance(abstract, TensorSpec):
        local = torch.zeros(shardings.shard_shape(abstract.shape),
                            dtype=abstract.dtype, device=device)
        return DTensor.from_local(local, shardings.mesh,
                                  shardings.placements(), run_check=False,
                                  shape=torch.Size(abstract.shape),
                                  stride=torch.empty(
                                      abstract.shape,
                                      device="meta").stride())
    if isinstance(abstract, opt_mod.OptState):
        return opt_mod.OptState(*(_materialize(getattr(abstract, k),
                                               getattr(shardings, k),
                                               device)
                                  for k in abstract._fields))
    if isinstance(abstract, dict):
        return {k: 0 if k == "pos" else _materialize(abstract[k],
                                                     shardings[k], device)
                for k in sorted(abstract)}
    return [_materialize(a, s, device) for a, s in zip(abstract, shardings)]


def cell_args(cell, cfg, device="meta") -> tuple:
    """The cell's arguments as DTensors on ``device`` (the train step's
    params as an ``LM``)."""
    from repro_torch.models.transformer import LM
    args = [_materialize(a, s, device)
            for a, s in zip(cell.args, cell.in_shardings)]
    args[0] = LM(args[0], cfg)
    return tuple(args)


def run_probe(cfg, shape, mesh, hp=None) -> Dict[str, Any]:
    """One eager run of the cell's step on ``meta`` under ``CostProbe``."""
    from repro_torch.training.steps import build_cell
    cell = build_cell(cfg, shape, mesh, hp, device="meta")
    args = cell_args(cell, cfg)
    with CostProbe() as probe:
        if shape.kind == "train":
            out = cell.fn(*args, on_update=lambda: probe.mark("update"))
        else:
            out = cell.fn(*args)
        del out
    del args
    return probe.result()


def _combine(base, deltas_with_mult):
    """base + Σ mult · (hi − lo) over every field (each phase's peak
    apart)."""
    keys = ("flops", "global_flops", "bytes") + tuple(
        k for k in base if k.startswith("peak_"))
    out = {k: base[k] for k in keys}
    out.update(payload=base["coll"]["payload_bytes"],
               link=base["coll"]["link_bytes"],
               counts=Counter(base["coll"]["counts"]),
               by_kind=Counter(base["coll"]["bytes_by_kind"]))
    for mult, (hi, lo) in deltas_with_mult:
        for k in keys:
            out[k] += mult * (hi[k] - lo[k])
        out["payload"] += mult * (hi["coll"]["payload_bytes"]
                                  - lo["coll"]["payload_bytes"])
        out["link"] += mult * (hi["coll"]["link_bytes"]
                               - lo["coll"]["link_bytes"])
        for field, src in (("counts", "counts"), ("by_kind",
                                                  "bytes_by_kind")):
            d = Counter(hi["coll"][src])
            d.subtract(lo["coll"][src])
            for kk, vv in d.items():
                out[field][kk] += mult * vv
    out["counts"] = Counter({k: int(round(v))
                             for k, v in out["counts"].items()})
    return out


def _depth_points(cfg) -> Dict[str, Any]:
    """The configs of the depth probe, by name: L = 1, 2 (the hybrid's
    ΔA from L = 2 with a shared attention block before every layer;
    encdec's e1d1, e2d1, e1d2)."""
    if cfg.family == "hybrid":
        import repro_torch.configs.base as cb
        return {"L1": cfg.replace(n_layers=1), "L2": cfg.replace(n_layers=2),
                "L2_ae1": cfg.replace(n_layers=2,
                                      hybrid=cb.HybridConfig(attn_every=1))}
    if cfg.family == "encdec":
        import repro_torch.configs.base as cb
        frac = cfg.encdec.encoder_frac
        return {f"e{e}d{d}": cfg.replace(n_layers=d,
                                         encdec=cb.EncDecConfig(e, frac))
                for e, d in ((1, 1), (2, 1), (1, 2))}
    return {"L1": cfg.replace(n_layers=1), "L2": cfg.replace(n_layers=2)}


def probe_plan(cfg, shape) -> list:
    """The probe's runs, each independent of the others (the dry-run
    spreads them over processes): ``(depth point, microbatch point, cfg,
    shape)``.  A train step of M > 3 microbatches is run on its
    microbatch's batch as two microbatches and as three: from the second
    on each microbatch repeats the same ops (its rows' gather, its step,
    its add into the gradient sum), so ``F(M) = F(2) + (M−2)·[F(3) −
    F(2)]`` (``probe_combine``)."""
    out = []
    for name, c in _depth_points(cfg).items():
        M = c.microbatches
        if shape.kind != "train" or M <= 3:
            out.append((name, "", c, shape))
            continue
        B = shape.global_batch // M
        for m in (2, 3):
            out.append((name, f"m{m}", c.replace(microbatches=m),
                        dataclasses.replace(shape, global_batch=m * B)))
    return out


def probe_combine(cfg, results: Dict[tuple, Dict[str, Any]]) -> CellCosts:
    """The cell's costs from its probe runs (``probe_plan``'s, keyed by
    (depth point, microbatch point)), by the reference's depth formulas:
    ``F(L) = F(1) + (L−1)·[F(2) − F(1)]``; the hybrid ``F(L) = F(1) +
    (L−1)·ΔM + (⌈L/ae⌉−1)·ΔA``, ΔA = F(L2, ae 1) − F(L2); encdec
    ``F(Le, Ld) = F(1,1) + (Le−1)·ΔE + (Ld−1)·ΔD``.  Each phase's peak
    is extrapolated apart and the larger taken."""
    pts = {}
    for (name, mb), r in results.items():
        pts.setdefault(name, {})[mb] = r
    for name, runs in pts.items():
        if "" in runs:
            pts[name] = runs[""]
            continue
        M = cfg.microbatches
        p2, p3 = runs["m2"], runs["m3"]
        c = _flat_point(_combine(p2, [(M - 2, (p3, p2))]))
        c.update({k: v for k, v in p3.items() if k.startswith("peak_")})
        pts[name] = c
    L = cfg.n_layers
    if cfg.family == "hybrid":
        c1, c2, ca = pts["L1"], pts["L2"], pts["L2_ae1"]
        tot = _combine(c1, [(L - 1, (c2, c1)),
                            (math.ceil(L / cfg.hybrid.attn_every) - 1,
                             (ca, c2))])
    elif cfg.family == "encdec":
        c11, c21, c12 = pts["e1d1"], pts["e2d1"], pts["e1d2"]
        tot = _combine(c11, [(cfg.encdec.n_encoder_layers - 1, (c21, c11)),
                             (L - 1, (c12, c11))])
    else:
        c1, c2 = pts["L1"], pts["L2"]
        tot = _combine(c1, [(L - 1, (c2, c1))])
    return CellCosts(flops=tot["flops"], global_flops=tot["global_flops"],
                     bytes=tot["bytes"], temp_bytes=max(
                         v for k, v in tot.items() if k.startswith("peak_")),
                     coll_payload=tot["payload"], coll_link=tot["link"],
                     coll_counts=dict(tot["counts"]),
                     coll_bytes_by_kind=dict(tot["by_kind"]),
                     probe_points=pts)


def probe_costs(cfg, shape, mesh, hp=None) -> CellCosts:
    """Depth probe and linear extrapolation (see the module docstring),
    its runs in this process.  Every chunk of a chunked family runs: a
    fit over small chunk counts (the reference's ``nc ∈ {2, 4, 8}``) does
    not hold here, as DTensor lays small shapes out otherwise."""
    return probe_combine(cfg, {(name, mb): run_probe(c, s, mesh, hp)
                               for name, mb, c, s in probe_plan(cfg, shape)})


def _flat_point(c) -> Dict[str, Any]:
    """A ``_combine`` result back in a probe point's layout."""
    return {"flops": c["flops"], "global_flops": c["global_flops"],
            "bytes": c["bytes"],
            **{k: v for k, v in c.items() if k.startswith("peak_")},
            "coll": {"payload_bytes": c["payload"], "link_bytes": c["link"],
                     "counts": dict(c["counts"]),
                     "bytes_by_kind": dict(c["by_kind"])}}


# ---------------------------------------------------------------------------
# Analytic model FLOPs (6·N·D convention)
# ---------------------------------------------------------------------------

def matmul_param_count(cfg) -> Tuple[float, float]:
    """(dense-equivalent matmul params, active matmul params).

    Counts every parameter that participates in a matmul (incl. the LM
    head, excl. the token-embedding gather).  For MoE the active count
    scales expert FFN params by top_k/E.
    """
    D, H, KV, Hd, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                             cfg.resolved_head_dim, cfg.d_ff, cfg.vocab,
                             cfg.n_layers)
    head = D * V
    if cfg.family in ("dense", "vlm"):
        attn = D * H * Hd + 2 * D * KV * Hd + H * Hd * D
        ffn = 3 * D * F
        tot = L * (attn + ffn) + head
        if cfg.family == "vlm":
            tot += cfg.vlm.patch_dim * D
        return tot, tot
    if cfg.family == "moe":
        attn = D * H * Hd + 2 * D * KV * Hd + H * Hd * D
        E, k = cfg.moe.n_experts, cfg.moe.top_k
        ffn_all = 3 * D * F * E
        gate = D * E
        tot = L * (attn + ffn_all + gate) + head
        act = L * (attn + 3 * D * F * k + gate) + head
        return tot, act
    if cfg.family == "ssm":  # rwkv6
        tmix = (4 * D * D + D * cfg.rwkv.decay_lora
                + cfg.rwkv.decay_lora * D + D * D)
        cmix = 2 * D * F + D * D
        tot = L * (tmix + cmix) + head
        return tot, tot
    if cfg.family == "hybrid":
        d_in = cfg.ssm.expand * D
        Hs = d_in // cfg.ssm.head_dim
        N = cfg.ssm.d_state
        mamba = 2 * D * d_in + 2 * D * N + D * Hs + d_in * D
        attn = D * H * Hd + 2 * D * KV * Hd + H * Hd * D + 3 * D * F
        napp = math.ceil(L / cfg.hybrid.attn_every)
        tot = L * mamba + napp * attn + head
        return tot, tot
    if cfg.family == "encdec":
        attn = D * H * Hd + 2 * D * KV * Hd + H * Hd * D
        ffn = 3 * D * F
        enc = cfg.encdec.n_encoder_layers * (attn + ffn)
        dec = L * (2 * attn + ffn)
        tot = enc + dec + head + D * D
        return tot, tot
    raise ValueError(cfg.family)


def model_flops(cfg, shape) -> float:
    """6·N_active·T (+ attention context term) for the given cell."""
    _, act = matmul_param_count(cfg)
    B, S = shape.global_batch, shape.seq_len
    Hd = cfg.resolved_head_dim

    def attn_ctx_flops(n_layers, heads, q_tokens, ctx, causal):
        # qk^T + att·v = 2 · 2 · q·ctx·heads·Hd  (×0.5 if causal averaged)
        f = 4 * q_tokens * ctx * heads * Hd
        return f * (0.5 if causal else 1.0)

    if shape.kind == "train":
        if cfg.family == "encdec":
            fr = int(S * cfg.encdec.encoder_frac)
            dec = S - fr
            # separate enc/dec token counts
            attn = (cfg.d_model * cfg.n_heads * Hd + 2 * cfg.d_model
                    * cfg.n_kv_heads * Hd + cfg.n_heads * Hd * cfg.d_model)
            ffn = 3 * cfg.d_model * cfg.d_ff
            enc_p = cfg.encdec.n_encoder_layers * (attn + ffn)
            dec_p = cfg.n_layers * (2 * attn + ffn)
            head = cfg.d_model * cfg.vocab
            f = 6 * (enc_p * B * fr + (dec_p + head) * B * dec)
            f += 3 * attn_ctx_flops(cfg.encdec.n_encoder_layers, cfg.n_heads,
                                    B * fr, fr, False)
            f += 3 * attn_ctx_flops(cfg.n_layers, cfg.n_heads, B * dec, dec,
                                    True)
            f += 3 * attn_ctx_flops(cfg.n_layers, cfg.n_heads, B * dec, fr,
                                    False)
            return f
        T = B * S
        f = 6.0 * act * T
        if cfg.family in ("dense", "vlm", "moe"):
            f += 3 * cfg.n_layers * attn_ctx_flops(1, cfg.n_heads, T, S, True)
        elif cfg.family == "hybrid":
            napp = math.ceil(cfg.n_layers / cfg.hybrid.attn_every)
            f += 3 * napp * attn_ctx_flops(1, cfg.n_heads, T, S, True)
        return f

    # inference: 2·N_active per token (+ attention over context)
    q_tokens = B * (S if shape.kind == "prefill" else 1)
    f = 2.0 * act * q_tokens
    ctx = S
    causal = shape.kind == "prefill"
    if cfg.family in ("dense", "vlm", "moe"):
        f += cfg.n_layers * attn_ctx_flops(1, cfg.n_heads, q_tokens, ctx,
                                           causal)
    elif cfg.family == "hybrid":
        napp = math.ceil(cfg.n_layers / cfg.hybrid.attn_every)
        f += napp * attn_ctx_flops(1, cfg.n_heads, q_tokens, ctx, causal)
    elif cfg.family == "encdec":
        fr = int(S * cfg.encdec.encoder_frac)
        dec = S - fr
        if shape.kind == "prefill":
            f = 2.0 * act * B * S  # enc on frames + dec prefill, roughly
        f += cfg.n_layers * attn_ctx_flops(1, cfg.n_heads, q_tokens, fr,
                                           False)
        f += cfg.n_layers * attn_ctx_flops(1, cfg.n_heads, q_tokens, dec,
                                           causal)
    return f
