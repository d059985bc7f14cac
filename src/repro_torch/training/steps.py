"""The train step: the port of the JAX package's ``make_train_step``.

``make_train_step(model, hp)`` returns ``full_step(params, opt_state,
batch) → (params, opt_state, {"loss", "lr", "grad_norm"})``: the loss and
its gradients by torch autograd, microbatched gradient accumulation in
float32, then the AdamW update (``optimizer.apply_update``).  The step
runs eagerly and updates ``params`` (an ``LM``) and ``opt_state`` in
place; the returned ones are the same objects.

With ``cfg.microbatches = M > 1`` every batch entry (``tokens``,
``labels``, and ``patches`` or ``frames`` where the family takes them)
splits M ways along its first dim; each microbatch's gradients (in the
params' dtype, as the reference differentiates bf16 params) are cast to
float32 and summed, the sum is divided by M and the loss averaged.
Gradients come out in the reference's tree: one stacked ``(L, ...)``
leaf each with ``cfg.scan_layers``.  The mesh, ``build_cell`` and the
shardings wait for the sharding port (ROADMAP A7(c)).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.params import leaves, torch_dtype, tree_map
from repro_torch.training import optimizer as opt_mod


def _on(x, device, dtype) -> torch.Tensor:
    """A batch entry on ``device``: float inputs (the VLM's ``patches``,
    the encdec's ``frames``) in the params' dtype, as the reference's
    forward casts them; ``tokens``/``labels`` keep their int dtype."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(device, dtype if x.is_floating_point() else None)


def make_train_step(model, hp: opt_mod.OptConfig):
    cfg = model.cfg
    pdt = torch_dtype(cfg.dtype)

    def loss_and_grads(params, batch):
        weights = leaves(params.tree())
        for w in weights:
            w.requires_grad_(True)
        loss = model.loss(params, batch)
        return loss.detach(), torch.autograd.grad(loss, weights)

    def train_step(params, batch):
        M = cfg.microbatches
        if M > 1:
            n = next(iter(batch.values())).shape[0] // M
            loss = torch.zeros((), dtype=torch.float32, device=model.device)
            gsum = None
            for i in range(M):
                mb = {k: v[i * n:(i + 1) * n] for k, v in batch.items()}
                mloss, grads = loss_and_grads(params, mb)
                loss = loss + mloss
                if gsum is None:
                    gsum = [g.to(torch.float32) for g in grads]
                else:
                    for a, g in zip(gsum, grads):
                        a.add_(g.to(torch.float32))
                del grads
            return loss / M, [g.div_(M) for g in gsum]
        loss, grads = loss_and_grads(params, batch)
        return loss, [g.to(torch.float32) for g in grads]

    def full_step(params, opt_state, batch):
        batch = {k: _on(v, model.device, pdt) for k, v in batch.items()}
        loss, flat = train_step(params, batch)
        it = iter(flat)
        grads = tree_map(lambda _: next(it), params.tree())
        del flat, it
        new, opt_state, om = opt_mod.apply_update(grads, opt_state, hp, pdt)
        del grads
        with torch.no_grad():
            for p, q in zip(leaves(params.tree()), leaves(new)):
                p.copy_(q)
        return params, opt_state, {"loss": loss, **om}

    return full_step
