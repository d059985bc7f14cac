"""End-to-end driver: pre-train a small LM on a random-walk corpus sampled
from a *generated* graph: the paper's synthetic-data-for-model-development
use case (§5, §8.4), wired into the LM training stack (checkpoints and
resume included).

    python -m repro_torch.examples.train_lm_on_graph_corpus \\
        [--steps 300] [--arch tinyllama-1.1b] [--device cpu]

The JAX example's arguments and steps: fit ``paysim_like`` with Kronecker
structure, random features and the random aligner, generate from it (on
the card through the in-register R-MAT kernel), walk it, and train a
model of ``--arch``'s family (tinyllama-1.1b by default; a moe, ssm or
hybrid config such as ``qwen3-moe-30b-a3b``, ``rwkv6-7b`` or
``zamba2-1.2b`` trains its own blocks) at the example's width (8 layers,
d 512, vocab 4096 by default) with ``Trainer``: checkpoints every 100
steps under ``--ckpt``, and a rerun resumes from the newest one there.
Prints the first-10 and last-10 mean losses.
"""
from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from repro_torch import random as trandom
from repro_torch.configs import get_config
from repro_torch.core.pipeline import SyntheticGraphPipeline
from repro_torch.data.pipeline import GraphWalkCorpus
from repro_torch.data.reference import paysim_like
from repro_torch.models import Model
from repro_torch.training.optimizer import OptConfig
from repro_torch.training.trainer import Trainer, TrainerConfig
from repro_torch.utils import tree_size


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="tinyllama-1.1b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--vocab", type=int, default=4096)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_lm_ckpt"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap.parse_args(argv)


def config(args):
    """The model: the architecture's family at the example's width."""
    return get_config(args.arch).replace(
        n_layers=args.layers, d_model=args.d_model, n_heads=8, n_kv_heads=4,
        head_dim=64, d_ff=4 * args.d_model, vocab=args.vocab, microbatches=1)


def main(argv=None) -> dict:
    args = parse_args(argv)

    # 1. generate a synthetic graph (the paper pipeline) ...
    g, cont, cat = paysim_like(n=args.vocab, n_edges=6 * args.vocab)
    pipe = SyntheticGraphPipeline(struct="kronecker", features="random",
                                  aligner="random", gan_steps=0,
                                  device=args.device)
    pipe.fit(g, cont, cat)
    g_syn, _, _ = pipe.generate(seed=0)
    print(f"generated graph: nodes={g_syn.n_nodes} edges={g_syn.n_edges}")

    # 2. ... random-walk corpus over it ...
    corpus = GraphWalkCorpus(g_syn, vocab=args.vocab)

    # 3. ... ~100M-param model from the assigned-arch family, scaled down
    model = Model(config(args), args.device)
    n_params = tree_size(model.abstract_params())
    print(f"model: {args.arch}-derived, {n_params/1e6:.1f}M params")

    hp = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    tr = Trainer(model, hp,
                 TrainerConfig(total_steps=args.steps, ckpt_every=100,
                               ckpt_dir=args.ckpt, log_every=25))
    params, opt_state = tr.fit(trandom.PRNGKey(0),
                               corpus.batches(args.batch, args.seq))
    losses = [h["loss"] for h in tr.history]
    print(f"loss: first10={np.mean(losses[:10]):.4f} "
          f"last10={np.mean(losses[-10:]):.4f}")
    return {"pipe": pipe, "graph": g_syn, "n_params": n_params,
            "trainer": tr, "params": params, "opt_state": opt_state,
            "losses": losses}


if __name__ == "__main__":
    main()
