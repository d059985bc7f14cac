"""Fault-tolerant training loop: the port of the JAX package's
``training/trainer.py``.

Composes the eager train step (``steps.py``), a data iterator, async
checkpoints and auto-resume.  Failure semantics, as the reference's:

* any exception inside a step (out of memory, an injected fault) →
  reload the latest checkpoint and continue from its step; after
  ``max_restarts`` consecutive failures the error propagates.  The
  checkpoint writer is joined first, so no writer thread outlives a
  restart or the error;
* checkpoints every ``ckpt_every`` steps (async) and at the end (awaited;
  not again when the last step was just saved, where the reference
  writes the same checkpoint twice);
* on (re)start the trainer restores the newest checkpoint if present, so
  restart-after-kill needs no extra flags.

``fit``'s ``data_it`` yields batch dicts of numpy arrays or tensors, as
the family's ``Model.loss`` takes them: ``tokens`` and ``labels``, and
``patches`` (VLM) or ``frames`` (encdec) beside them.

``history`` holds one ``{"step", "loss", "grad_norm", "dt"}`` per step
(``dt``: host seconds of the step, which ends on reading the loss).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Iterator, Optional

import numpy as np

from repro_torch.distributed import checkpoint as ckpt_mod
from repro_torch.training import optimizer as opt_mod
from repro_torch.training.steps import make_train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 20
    ckpt_dir: Optional[str] = None
    keep: int = 3
    max_restarts: int = 3
    log_every: int = 10


class Trainer:
    def __init__(self, model, hp: opt_mod.OptConfig, tcfg: TrainerConfig):
        self.model = model
        self.hp = hp
        self.tcfg = tcfg
        self.step_fn = make_train_step(model, hp)
        self.ckpt = (ckpt_mod.AsyncCheckpointer(tcfg.ckpt_dir, tcfg.keep)
                     if tcfg.ckpt_dir else None)
        self.history: list = []

    def init_state(self, rng):
        params = self.model.init_params(rng)
        opt_state = opt_mod.init_opt_state(params)
        return params, opt_state

    def _try_restore(self, params, opt_state):
        if not self.tcfg.ckpt_dir:
            return params, opt_state, 0
        step = ckpt_mod.latest_step(self.tcfg.ckpt_dir)
        if step is None:
            return params, opt_state, 0
        (params, opt_state), step = ckpt_mod.restore(
            self.tcfg.ckpt_dir, (params, opt_state), step)
        return params, opt_state, step

    def fit(self, rng, data_it: Iterator[Dict[str, np.ndarray]],
            fault_hook: Optional[Callable[[int], None]] = None):
        params, opt_state = self.init_state(rng)
        params, opt_state, start = self._try_restore(params, opt_state)
        step, saved = start, (start or None)
        restarts = 0
        while step < self.tcfg.total_steps:
            try:
                batch = next(data_it)
                if fault_hook is not None:
                    fault_hook(step)          # test hook: raise to simulate
                t0 = time.time()
                params, opt_state, metrics = self.step_fn(params, opt_state,
                                                          batch)
                loss = float(metrics["loss"])
                step += 1
                restarts = 0
                self.history.append({
                    "step": step, "loss": loss,
                    "grad_norm": float(metrics["grad_norm"]),
                    "dt": time.time() - t0})
                if step % self.tcfg.log_every == 0:
                    print(f"[train] step={step} loss={loss:.4f} "
                          f"dt={self.history[-1]['dt']*1e3:.0f}ms")
                if self.ckpt and step % self.tcfg.ckpt_every == 0:
                    self.ckpt.save_async(step, (params, opt_state))
                    saved = step
            except KeyboardInterrupt:
                raise
            except Exception as e:  # noqa: BLE001 — node-failure recovery
                restarts += 1
                print(f"[train] step {step} failed ({type(e).__name__}: "
                      f"{str(e)[:100]}); restart {restarts}/"
                      f"{self.tcfg.max_restarts}")
                if self.ckpt:
                    self.ckpt.wait()
                if restarts > self.tcfg.max_restarts or not self.tcfg.ckpt_dir:
                    raise
                params = opt_state = None     # hold one state at a time
                params, opt_state = self.init_state(rng)
                params, opt_state, step = self._try_restore(params, opt_state)
                saved = step
        if self.ckpt:
            if step != saved:     # the reference saves its last step twice
                self.ckpt.save_async(step, (params, opt_state))
            self.ckpt.wait()
        return params, opt_state
