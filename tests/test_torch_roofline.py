"""The port's dry-run and roofline tables against ``benchmarks/roofline.py``:
fed the same cells (the port's keys renamed to the reference's:
``collectives`` → ``collectives_scan_hlo``, ``counted_flops_total`` →
``hlo_flops_total``, ``t_probe_s`` → ``t_compile_s``), ``dryrun_table`` and
``roofline_table`` give the same text, and ``run`` the same rows."""
import copy
import importlib.util
import json
import os

import pytest

from repro_torch.benchmarks import roofline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_roofline(monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    spec = importlib.util.spec_from_file_location(
        "jax_benchmarks_roofline", os.path.join(ROOT, "benchmarks",
                                                "roofline.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cell(arch, shape, mesh, family, dom, useful, **kw):
    c = {"arch": arch, "shape": shape, "mesh": mesh, "tag": "",
         "config": {"family": family, "n_layers": 2, "d_model": 64,
                    "microbatches": 1, "remat_policy": "nothing",
                    "moe_path": "tp"},
         "status": "ok", "t_probe_s": 3.25,
         "memory_analysis": {"argument_bytes": 3 << 30, "output_bytes": 1,
                             "temp_bytes": 5 << 29, "alias_bytes": 1,
                             "peak_bytes_per_device": (3 << 30) + (5 << 29)},
         "collectives": {"counts": {"all-reduce": 7, "all-gather": 3},
                         "payload_bytes": 10, "link_bytes": 12.0},
         "roofline": {"chips": 256, "compute_s": 0.0123,
                      "memory_s": 0.0456, "collective_s": 0.0789,
                      "dominant": dom, "model_flops": 1.234e15,
                      "counted_flops_total": 2.345e15,
                      "useful_ratio": useful}}
    c.update(kw)
    return c


CELLS = [
    _cell("llama3_8b", "train_4k", "single", "dense", "collective", 0.38),
    _cell("qwen3_moe_30b_a3b", "train_4k", "single", "moe", "collective",
          0.35),
    _cell("tinyllama_1_1b", "prefill_32k", "single", "dense", "memory",
          0.58),
    _cell("rwkv6_7b", "decode_32k", "single", "ssm", "memory", 0.98),
    _cell("zamba2_1_2b", "decode_32k", "single", "hybrid", "memory", 0.93),
    _cell("glm4_9b", "train_4k", "single", "dense", "compute", 0.45),
    _cell("glm4_9b", "prefill_32k", "single", "dense", "compute", 0.75),
    _cell("llama3_8b", "train_4k", "multi", "dense", "collective", 0.38),
    _cell("llama3_8b", "train_4k", "single", "dense", "memory", 0.5,
          tag="fsdp"),
    {"arch": "tinyllama_1_1b", "shape": "long_500k", "mesh": "single",
     "tag": "", "status": "skipped", "config": {"family": "dense"},
     "reason": "full-attention family 'dense': 524k-token dense KV decode "
               "is architecturally quadratic"},
    {"arch": "seamless_m4t_medium", "shape": "train_4k", "mesh": "multi",
     "tag": "", "status": "error", "config": {"family": "encdec"},
     "error": "RuntimeError: something did not lay out"},
    {"arch": "graphgen-rmat", "shape": "1t", "mesh": "single",
     "mode": "threefry", "status": "ok",
     "roofline": {"chips": 256, "compute_s": 0.001, "memory_s": 0.0002,
                  "collective_s": 0.0, "dominant": "compute"}},
]


def _as_reference(cell):
    c = copy.deepcopy(cell)
    if "collectives" in c:
        c["collectives_scan_hlo"] = c.pop("collectives")
    if "t_probe_s" in c:
        c["t_compile_s"] = c.pop("t_probe_s")
    rl = c.get("roofline", {})
    if "counted_flops_total" in rl:
        rl["hlo_flops_total"] = rl.pop("counted_flops_total")
    return c


def test_tables_equal_the_reference(jax_roofline):
    ref = [_as_reference(c) for c in CELLS]
    assert roofline.dryrun_table(CELLS) == jax_roofline.dryrun_table(ref)
    assert roofline.roofline_table(CELLS) == \
        jax_roofline.roofline_table(ref)
    assert roofline.roofline_table(CELLS).count("\n") == 8


def test_run_rows_equal_the_reference(jax_roofline, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    for sub, cells in (("dryrun_torch", CELLS),
                       ("dryrun", [_as_reference(c) for c in CELLS])):
        d = tmp_path / "results" / sub
        d.mkdir(parents=True)
        for i, c in enumerate(cells):
            (d / f"{i:02d}.json").write_text(json.dumps(c))
    got = roofline.run(fast=True, device="cpu")
    want = jax_roofline.run(fast=True)
    assert [(r["name"], r["derived"]) for r in got] == \
        [(r["name"], r["derived"]) for r in want]
    assert got[0]["derived"] == "ok=10;skip=1;err=1"
