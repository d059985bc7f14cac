"""AdamW with a float32 master copy: the port of the JAX package's
``training/optimizer.py``.

Compute params live in the model dtype (bf16); the optimizer keeps a
float32 master copy plus Adam moments, and each step returns the masters
cast back to the model dtype.  The update is the reference's, not
``torch.optim.AdamW``'s: lr in float32 from ``step + 1`` (linear warmup,
cosine decay to ``min_lr_frac``), every gradient clipped by one global
norm, bias-corrected moments, and decay ``lr · weight_decay · p`` inside
the step, on every leaf (norms and embeddings too).

Trees are the port's dict/list trees in jax's leaf order (an ``LM``
stands for its ``tree()``).  ``apply_update`` updates the state's tensors
in place (the reference returns new arrays), so a full-width state is
held once.  Under a mesh the state's leaves are DTensors laid out by
``training.steps.opt_state_shardings`` (ZeRO-1: the weight's spec and
``data`` on its first free divisible dim) and the same ops run on
them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from repro_torch.models.params import TensorSpec, leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    max_grad_norm: float = 1.0


class OptState(NamedTuple):
    master: Any     # fp32 params
    mu: Any
    nu: Any
    step: torch.Tensor   # int32, shape ()


def _tree(params):
    return params.tree() if callable(getattr(params, "tree", None)) \
        else params


def init_opt_state(params) -> OptState:
    """Masters are float32 copies of ``params``, moments zeros, on the
    params' device."""
    tree = _tree(params)
    master = tree_map(lambda x: x.detach().to(torch.float32, copy=True),
                      tree)
    zeros = lambda: tree_map(  # noqa: E731
        lambda x: torch.zeros(x.shape, dtype=torch.float32,
                              device=x.device), tree)
    device = leaves(tree)[0].device
    return OptState(master=master, mu=zeros(), nu=zeros(),
                    step=torch.zeros((), dtype=torch.int32, device=device))


def abstract_opt_state(abstract_params) -> OptState:
    f32 = lambda: tree_map(  # noqa: E731
        lambda x: TensorSpec(tuple(x.shape), torch.float32),
        _tree(abstract_params))
    return OptState(master=f32(), mu=f32(), nu=f32(),
                    step=TensorSpec((), torch.int32))


def lr_schedule(hp: OptConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to ``min_lr_frac``, in float32."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(hp.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - hp.warmup_steps)
                    / max(hp.total_steps - hp.warmup_steps, 1), 0.0, 1.0)
    cos = hp.min_lr_frac + (1 - hp.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return hp.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in leaves(_tree(tree))))


def apply_update(grads, state: OptState, hp: OptConfig, param_dtype):
    """One AdamW step.  grads: float32 tree of the params' structure.
    Updates ``state``'s tensors in place; returns (params in
    ``param_dtype``, the state with its new step, {"lr", "grad_norm"})."""
    step = state.step + 1
    lr = lr_schedule(hp, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(hp.max_grad_norm / (gnorm + 1e-9), max=1.0)
    b1, b2 = hp.beta1, hp.beta2
    c1 = 1.0 - b1 ** step.to(torch.float32)
    c2 = 1.0 - b2 ** step.to(torch.float32)

    with torch.no_grad():
        for g, m, v, p in zip(leaves(_tree(grads)), leaves(state.mu),
                              leaves(state.nu), leaves(state.master)):
            g = g.to(torch.float32) * clip
            m.mul_(b1).add_(g * (1 - b1))
            v.mul_(b2).add_(g * (1 - b2) * g)
            mh = m / c1
            vh = v / c2
            p.sub_(lr * (mh / (torch.sqrt(vh) + hp.eps)
                         + hp.weight_decay * p))
    params = tree_map(lambda p: p.to(param_dtype, copy=True), state.master)
    return params, state._replace(step=step), {"lr": lr, "grad_norm": gnorm}
