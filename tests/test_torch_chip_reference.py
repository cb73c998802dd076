"""``chip_smoke.py``'s reference counts are the installed JAX reference's.

``chip_smoke.py`` gates adult's Table-1 iterations (and its dense batched
rows) on ``REFERENCE`` / ``REFERENCE_BATCHED``, adult's straggler run on
``REFERENCE_STRAGGLER``, and adult's grid and LOO correct counts on
``REFERENCE_GRID`` / ``REFERENCE_LOO``; it prints heart's beside them.
These tests run the reference itself on the CPU and hold the tables to
what it gives. The script is loaded by path; importing it touches no CUDA
device.
"""
import importlib.util
from pathlib import Path

import pytest

from repro.core.cv import run_cv, run_cv_batched, run_loo
from repro.core.grid import run_grid
from repro.data.svm_suite import make_dataset

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(chip_smoke)


@pytest.mark.parametrize("method", ["cold", "ato", "mir", "sir"])
@pytest.mark.parametrize("name", ["adult", "heart"])
def test_table1_reference_counts(name, method):
    want = chip_smoke.REFERENCE[name]
    rep = run_cv(make_dataset(name, n_override=want["n"]), k=10,
                 method=method)
    assert rep.total_iterations == want["iterations"][method]
    assert round(rep.accuracy, 4) == want["accuracy"]


@pytest.mark.parametrize("method,kw", [
    ("cold_batched", {"schedule": "batched"}),
    ("cold_batched_repacked", {}),
])
@pytest.mark.parametrize("name", ["adult", "heart"])
def test_batched_reference_counts(name, method, kw):
    want = chip_smoke.REFERENCE[name]
    rep = run_cv_batched(make_dataset(name, n_override=want["n"]), k=10,
                         **kw)
    assert rep.method == method
    assert rep.total_iterations == chip_smoke.REFERENCE_BATCHED[name][method]
    assert round(rep.accuracy, 4) == want["accuracy"]


@pytest.mark.parametrize("name", ["adult", "heart"])
def test_straggler_reference_counts(name):
    want = chip_smoke.REFERENCE_STRAGGLER[name]
    rep = run_cv(make_dataset(name, n_override=want["n"]), k=10,
                 method="sir", straggler_policy="best_available",
                 unavailable_folds=chip_smoke.STRAGGLER_LOST)
    assert [f.seed_from for f in rep.folds] == want["seed_from"]
    assert [f.n_iter for f in rep.folds] == want["per_fold"]
    assert round(rep.accuracy, 4) == want["accuracy"]


@pytest.mark.parametrize("method", ["sir", "ato"])
@pytest.mark.parametrize("name", ["adult", "heart"])
def test_grid_reference_counts(name, method):
    want = chip_smoke.REFERENCE_GRID[name]
    ds = make_dataset(name, n_override=want["n"])
    gammas = [g * ds.gamma for g in chip_smoke.GRID_GAMMA]
    rep = run_grid(ds, [c * ds.C for c in chip_smoke.GRID_C],
                   gammas if method == "sir" else gammas[:1],
                   k=chip_smoke.GRID_K, method=method)
    assert [[c.C, c.gamma, c.iterations, c.acc_correct]
            for c in rep.cells] == want[method]


@pytest.mark.parametrize("method", list(chip_smoke.REFERENCE_LOO))
def test_loo_reference_counts(method):
    name, n, rounds = chip_smoke.LOO_ADULT
    got = run_loo(make_dataset(name, n_override=n), method=method,
                  rounds=rounds)
    assert [got["base_iterations"], got["iterations"], got["accuracy"]] \
        == chip_smoke.REFERENCE_LOO[method]
