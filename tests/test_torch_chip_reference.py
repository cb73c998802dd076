"""``chip_smoke.py``'s reference counts are the installed JAX reference's.

``chip_smoke.py`` gates adult's Table-1 iterations (and its dense batched
rows) on ``REFERENCE`` / ``REFERENCE_BATCHED``, and prints heart's beside
them. These tests run the reference itself on the CPU (k=10) and hold the
two tables to what it gives. The script is loaded by path; importing it
touches no CUDA device.
"""
import importlib.util
from pathlib import Path

import pytest

from repro.core.cv import run_cv, run_cv_batched
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
