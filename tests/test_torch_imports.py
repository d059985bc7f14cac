"""The port stands alone: no module of ``src/repro_torch`` and not
``chip_smoke.py`` imports JAX or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]


def _banned(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            bad += [a.name for a in node.names if _banned(a.name)]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            if _banned(node.module or ""):
                bad.append(node.module)
    assert not bad, f"{path.name} imports {bad}"


def test_scan_sees_the_package():
    names = {p.name for p in FILES}
    assert {"random.py", "rmat_sample.py", "pipeline.py",
            "flash_attention.py", "engine.py", "transformer.py",
            "layers.py", "spike.py", "metrics.py", "fit_engine.py",
            "reference.py", "chip_smoke.py", "scheduler.py", "writer.py",
            "executor.py", "service.py", "distributed_gen.py", "trace.py",
            "generate_dataset.py", "fitsource.py", "fit_dataset.py",
            "gnn.py", "bounds.py", "export.py", "report_run.py",
            "fig8_throughput.py", "feature_throughput.py"} <= names
