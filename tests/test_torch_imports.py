"""Import rule of the port: no module of ``src/repro_torch/``, and none of
``chip_smoke.py``, ``chip_flash_mutants.py``, ``chip_smo_variants.py``,
``chip_sir_split.py``, ``chip_ato_split.py``, ``chip_ato_phases.py``,
``chip_spill_phases.py``, ``chip_cost_model.py`` and
``chip_flash_shapes.py``, imports jax or the JAX package ``repro``; and
every entry point defaults to ``cuda``, raising without a GPU unless given
``device="cpu"``."""
import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) \
    + [ROOT / "chip_smoke.py", ROOT / "chip_flash_mutants.py",
       ROOT / "chip_smo_variants.py", ROOT / "chip_sir_split.py",
       ROOT / "chip_ato_split.py", ROOT / "chip_ato_phases.py",
       ROOT / "chip_spill_phases.py", ROOT / "chip_cost_model.py",
       ROOT / "chip_flash_shapes.py"]


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
            "convert.py", "flash_attention.py", "attention.py",
            "transformer.py", "layers.py", "params.py", "decode.py",
            "inputs.py", "tokens.py", "granite_8b.py", "gemma_7b.py",
            "threefry.py", "chip_smo_variants.py", "grid.py", "shrink.py",
            "svc.py", "manager.py", "findings.py", "plan_check.py",
            "plan_sim.py", "protocol.py", "server.py", "client.py",
            "__main__.py", "chip_cost_model.py", "imports.py",
            "jit_lint.py", "kernel_lint.py", "yi_34b.py",
            "gemma3_4b.py", "moe.py", "deepseek_v2_236b.py",
            "deepseek_v3_671b.py", "chip_flash_shapes.py"} <= names
    analysis = ROOT / "src" / "repro_torch" / "analysis"
    assert analysis / "__main__.py" in FILES


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.convert import result_from_reference
    from repro_torch.core.cv import run_cv, run_cv_batched, run_loo
    from repro_torch.core.grid import grid_plans, run_grid
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
    for method in ("cold", "avg", "sir"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            run_loo(ds, method=method, rounds=2)
    for entry in (run_grid, grid_plans):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(ds, [1.0], [0.1], k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_plan(Plan(sources={}, y=ds.y))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        result_from_reference({})
    from repro_torch.svm import SVC
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SVC().fit(ds.X, ds.y)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SVC().cross_validate(ds.X, ds.y, k=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_cv(ds, k=4, method="sir", shrink_every=64)
    # the daemon and an empty pool run on cuda unless told otherwise; a
    # wire plan parsed without a device names none, so it runs on cuda
    from repro_torch.core.study import plan_from_dict, plan_to_dict
    from repro_torch.service import StudyService
    from repro_torch.svm import LanePool
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StudyService()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanePool({}, {})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LanePool({}, {}, device=None)
    wire = plan_to_dict(Plan(sources={}, y=ds.y))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_plan(plan_from_dict(wire))
    assert StudyService(device="cpu").pool.device == torch.device("cpu")
    assert LanePool({}, {}, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")


def test_lm_entry_points_default_to_cuda():
    """Building a model, a cache, a batch or converted parameters without
    ``device="cpu"`` raises when there is no GPU; a model built on the CPU
    serves there."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid here")
    from repro_torch.configs import get_config
    from repro_torch.convert import (cache_from_reference,
                                     model_params_from_reference)
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import init_cache, init_model
    from repro_torch.serving import build_serve_step, prefill_logits
    cfg = get_config("granite-8b", smoke=True)
    for build in (lambda: init_model(cfg), lambda: init_cache(cfg, 1, 4),
                  lambda: concrete_batch(cfg, 1, 4),
                  lambda: model_params_from_reference({}, cfg),
                  lambda: cache_from_reference({}, cfg)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build()
    model = init_model(cfg, dtype=torch.float32, device="cpu")
    batch = concrete_batch(cfg, 1, 4, device="cpu")
    assert prefill_logits(model, batch).shape == (1, 1, cfg.vocab_size)
    cache = init_cache(cfg, 1, 4, torch.float32, device="cpu")
    nxt, _ = build_serve_step(cfg)(model, cache, {
        "tokens": batch["tokens"][:, :1], "step": 0})
    assert nxt.shape == (1,)
