"""Import rule of the port: no module of ``src/repro_torch/`` and not
``chip_smoke.py`` imports jax or the JAX package ``repro``; and every entry
point defaults to ``cuda``, raising without a GPU unless given
``device="cpu"``."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py"]


def _imported(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported(ast.parse(path.read_text()))
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_the_walk_sees_the_port():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "engine.py", "seeding.py", "cv.py",
            "rbf.py", "smo_chunk.py", "smo_update.py", "smo_step.py",
            "scheduler.py", "sources.py", "cost_model.py", "study.py",
            "convert.py"} <= names


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.convert import result_from_reference
    from repro_torch.core.cv import run_cv, run_cv_batched
    from repro_torch.core.study import Plan, run_plan
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.device import resolve_device
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    ds = make_dataset("heart", n_override=40)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cv(ds, k=4, method="cold")
    for kw in ({}, {"schedule": "batched"}, {"source_backend": "pallas_rbf"}):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_cv_batched(ds, k=4, **kw)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_plan(Plan(sources={}, y=ds.y))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        result_from_reference({})
    assert resolve_device("cpu") == torch.device("cpu")
