"""Export a fitted JAX-package pipeline as a framework-free state for the
PyTorch port (``repro_torch.convert.pipeline_from_state``).

    PYTHONPATH=src python scripts/export_torch_state.py            # asset
    PYTHONPATH=src python scripts/export_torch_state.py --out fit.npz

With no arguments it fits ``repro.data.reference.tabformer_like()`` at its
defaults with the quickstart's settings (``noise=0.03, gan_steps=200``)
and writes ``src/repro_torch/assets/tabformer_like_fit.npz``, the fit that
``chip_smoke.py`` generates from.  ``state_from_jax_pipeline`` is also
what the port's parity tests use to carry a fit across.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
ASSET = ROOT / "src" / "repro_torch" / "assets" / "tabformer_like_fit.npz"


def _forest(out, prefix, binned, base, cfg, n_classes=None):
    if binned is None:
        raise ValueError(f"{prefix}: forest has no bin-quantized pack (a "
                         "threshold off its bin grid); the port needs one")
    out[f"{prefix}/E"] = np.asarray(binned["E"], np.float32)
    out[f"{prefix}/code"] = np.asarray(binned["code"], np.int32)
    out[f"{prefix}/leaf_bot"] = np.asarray(binned["leaf_bot"], np.float32)
    out[f"{prefix}/base"] = np.asarray(base, np.float32)
    out[f"{prefix}/lr"] = np.float32(cfg.lr)
    out[f"{prefix}/depth"] = np.int64(cfg.max_depth)
    if n_classes is not None:
        out[f"{prefix}/n_classes"] = np.int64(n_classes)


def state_from_jax_pipeline(pipe) -> dict:
    """The state dict of a fitted ``repro.core.pipeline
    .SyntheticGraphPipeline`` with kronecker structure and GAN features."""
    if pipe.struct_kind != "kronecker" or pipe.feat_kind != "gan":
        raise ValueError("the port carries kronecker + gan pipelines")
    st = pipe.struct
    out = {f"struct/{k}": np.float64(getattr(st, k))
           for k in ("a", "b", "c", "d", "noise")}
    out.update({f"struct/{k}": np.int64(getattr(st, k))
                for k in ("n", "m", "E")})
    out["struct/bipartite"] = np.bool_(st.bipartite)
    out["pipe/feature_kind"] = np.str_(pipe.feature_kind)
    out["pipe/bipartite"] = np.bool_(pipe._g_ref.bipartite)
    out["schema/n_cont"] = np.int64(pipe.schema.n_cont)
    out["schema/cat_cards"] = np.asarray(pipe.schema.cat_cards, np.int64)

    gan = pipe.features
    out["gan/n_modes"] = np.int64(gan.codec.n_modes)
    out["gan/d_z"] = np.int64(gan.cfg.d_z)
    out["gan/n_blocks"] = np.int64(gan.cfg.n_blocks)
    out["gan/sample_batch"] = np.int64(gan.cfg.sample_batch)
    for j, v in enumerate(gan.codec.vgms):
        for f in ("weights", "means", "stds", "active"):
            out[f"gan/vgm/{j}/{f}"] = np.asarray(getattr(v, f))
    g = gan.params["g"]
    for name in ("in", "out"):
        out[f"gan/g/{name}/w"] = np.asarray(g[name]["w"], np.float32)
        out[f"gan/g/{name}/b"] = np.asarray(g[name]["b"], np.float32)
    for i, blk in enumerate(g["blocks"]):
        p = f"gan/g/blocks/{i}"
        out[f"{p}/bn/scale"] = np.asarray(blk["bn"]["scale"], np.float32)
        out[f"{p}/bn/bias"] = np.asarray(blk["bn"]["bias"], np.float32)
        out[f"{p}/fc/w"] = np.asarray(blk["fc"]["w"], np.float32)
        out[f"{p}/fc/b"] = np.asarray(blk["fc"]["b"], np.float32)

    al = pipe.aligner
    if pipe.aligner_kind == "random":
        out["aligner/kind"] = np.str_("random")
        return out
    out["aligner/kind"] = np.str_("xgboost")
    out["aligner/col_quality"] = np.asarray(al.col_quality, np.float64)
    out["aligner/max_cat_classes"] = np.int64(al.cfg.max_cat_classes)
    for j, mdl in enumerate(al.cont_models):
        _forest(out, f"aligner/cont/{j}", mdl._binned, mdl.base, mdl.cfg)
    for j, mdl in enumerate(al.cat_models):
        if mdl is not None:
            _forest(out, f"aligner/cat/{j}", mdl._binned,
                    np.asarray(mdl._base), mdl.cfg, mdl.n_classes)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ASSET))
    ap.add_argument("--noise", type=float, default=0.03)
    ap.add_argument("--gan-steps", type=int, default=200)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(ROOT / "src"))
    from repro.core.pipeline import SyntheticGraphPipeline
    from repro.data.reference import tabformer_like
    from repro_torch.convert import save_state

    g, cont, cat = tabformer_like()
    t0 = time.time()
    pipe = SyntheticGraphPipeline(struct="kronecker", features="gan",
                                  aligner="xgboost", noise=args.noise,
                                  gan_steps=args.gan_steps)
    pipe.fit(g, cont, cat)
    state = state_from_jax_pipeline(pipe)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    save_state(state, args.out)
    st = pipe.struct
    print(f"fit in {time.time() - t0:.1f}s: n={st.n} m={st.m} E={st.E} "
          f"theta=[[{st.a:.4f}, {st.b:.4f}], [{st.c:.4f}, {st.d:.4f}]] "
          f"noise={st.noise:.4f} -> {args.out} "
          f"({Path(args.out).stat().st_size} bytes)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
