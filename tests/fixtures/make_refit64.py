#!/usr/bin/env python3
"""Writes the scale-64 refit fixture on one CUDA card:

    python3 tests/fixtures/make_refit64.py [--out tests/fixtures]

Draws the dataset of ``chip_smoke.py``'s phase 13(a) (the committed asset
at ``scale_nodes=64``: 163 840 000 int32 edges, shards of 2^24, seed 0,
``pipeline_depth=2``) with ``repro_torch.datastream.DatasetJob``, fits it
back with ``python -m repro_torch.scripts.fit_dataset`` at its defaults
(2^20-row chunks, calibration on), and keeps what the structure fit reads
beyond the fit JSON itself:

- ``refit64.json``: the CLI's output, byte for byte;
- ``refit64_hists.npz``: ``hist_out`` and ``hist_in`` (int64, kmax + 1
  bins), whose digests the JSON's ``degree_sketch`` block carries.

``tests/test_torch_fit_engine.py`` feeds both to the JAX package's and
the port's ``fit_structure_streamed`` on the CPU and requires the JSON
back; ``chip_smoke.py`` requires the CLI to write the same JSON on the
card.  The dataset is removed afterwards.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--out", default=str(ROOT / "tests" / "fixtures"),
                    help="directory for refit64.json and refit64_hists.npz")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("make_refit64: no CUDA card visible", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch import convert
    from repro_torch.core import fit_engine as fe
    from repro_torch.datastream import DatasetFitSource, DatasetJob
    from repro_torch.scripts import fit_dataset

    pipe = convert.pipeline_from_state(convert.load_state(cs.ASSET),
                                       device="cuda")
    os.makedirs(args.out, exist_ok=True)
    work = tempfile.mkdtemp(prefix="refit64_")
    try:
        path = os.path.join(work, "struct64")
        DatasetJob(pipe.struct.scaled(cs.STREAM_SCALE), path,
                   shard_edges=cs.STREAM_SHARD, seed=0,
                   pipeline_depth=2).run()
        out_json = os.path.join(args.out, "refit64.json")
        rc = fit_dataset.main(["--dataset", path, "--out", out_json])
        stats = fe.accumulate(DatasetFitSource(path), device="cuda")
    finally:
        shutil.rmtree(work, ignore_errors=True)
    with open(out_json) as f:
        sketch = json.load(f)["provenance"]["degree_sketch"]
    if (stats._hist_digest(stats.hist_out) != sketch["hist_out_digest"]
            or stats._hist_digest(stats.hist_in) != sketch["hist_in_digest"]):
        print("make_refit64: the histograms do not match the JSON's "
              "digests", file=sys.stderr)
        return 1
    np.savez_compressed(os.path.join(args.out, "refit64_hists.npz"),
                        hist_out=stats.hist_out.astype(np.int64),
                        hist_in=stats.hist_in.astype(np.int64))
    print(f"make_refit64: fit_dataset exit code {rc}; wrote {out_json} and "
          "refit64_hists.npz")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
