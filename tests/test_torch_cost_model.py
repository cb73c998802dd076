"""The port's cost model: its own file, ``results/cost_model_torch.json``,
holds the reference's ``cpu`` entry verbatim (so the port's CPU verdicts
are the reference's) and ``cuda`` entries measured on the card by
``chip_cost_model.py``, whose rules are the reference's; the loader's path
override and cache are the reference's; pools built with ``max_width=None``
and ``shrink_every="auto"`` take the file's verdicts."""
import importlib.util
import json
import pathlib

import pytest
import torch

from repro.svm import cost_model as ref_cost_model

from repro_torch.svm import DenseKernel, LanePool, PallasRBF, cost_model

ROOT = pathlib.Path(__file__).resolve().parents[1]
KINDS = [("dense",), ("pallas_rbf",), ("dense", "pallas_rbf")]


def _chip_cost_model():
    spec = importlib.util.spec_from_file_location(
        "chip_cost_model", ROOT / "chip_cost_model.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_the_port_reads_its_own_file():
    assert cost_model.DEFAULT_PATH == ROOT / "results" / \
        "cost_model_torch.json"
    assert cost_model.model_path() == cost_model.DEFAULT_PATH


def test_cpu_entry_is_the_references_verbatim():
    mine = json.loads((ROOT / "results" / "cost_model_torch.json")
                      .read_text())
    ref = json.loads((ROOT / "results" / "cost_model.json").read_text())
    assert mine["schema"] == ref["schema"] == 1
    assert mine["entries"]["cpu"] == ref["entries"]["cpu"]
    assert mine["meta"]["cpu"]["source"] == "results/cost_model.json"
    assert mine["meta"]["cpu"]["reference_meta"] == ref["meta"]["cpu"]


@pytest.mark.parametrize("kinds", KINDS)
def test_cpu_verdicts_are_the_references(kinds):
    assert cost_model.pick_max_width("cpu", kinds) == \
        ref_cost_model.pick_max_width("cpu", kinds) == 1
    assert cost_model.pick_shrink("cpu", kinds) == \
        ref_cost_model.pick_shrink("cpu", kinds) == (kinds == ("pallas_rbf",))


def test_cuda_entry_is_measured_on_the_card():
    model = cost_model.load()
    meta = model["meta"]["cuda"]
    assert meta["script"] == "chip_cost_model.py"
    name, watts = (part.strip() for part in meta["card"].split(","))
    assert name.startswith("NVIDIA") and watts.endswith("W")
    assert (meta["n"], meta["d"], meta["widths"]) == (1000, 40, [1, 2, 4, 8])
    rules = _chip_cost_model()
    for kind in ("dense", "pallas_rbf"):
        entry = model["entries"]["cuda"][kind]
        assert set(entry["us_per_lane_iter"]) == {"1", "2", "4", "8"}
        assert set(entry["us_per_iter_by_n"]) == {"250", "500", "1000"}
        # the verdicts are the rules' on the measured numbers
        assert entry["max_width"] == rules.width_verdict(
            entry["us_per_lane_iter"], meta["widths"])
        assert entry["shrink"] == rules.shrink_verdict(
            entry["us_per_iter_by_n"])
        assert cost_model.pick_max_width("cuda", (kind,)) == \
            entry["max_width"]
        assert cost_model.pick_shrink("cuda", (kind,)) == entry["shrink"]


@pytest.mark.parametrize("cost,want", [
    ({"1": 10.0, "2": 9.5, "4": 9.2, "8": 9.3}, 1),     # within SLACK
    ({"1": 10.0, "2": 8.0, "4": 7.0, "8": 7.5}, 4),
    ({"1": 10.0, "2": 5.0, "4": 2.5, "8": 1.3}, 0),     # widest: unbounded
])
def test_width_rule_is_the_references(cost, want):
    assert _chip_cost_model().width_verdict(cost, [1, 2, 4, 8]) == want


@pytest.mark.parametrize("cost,want", [
    ({"250": 5.0, "500": 7.0, "1000": 10.0}, True),
    ({"250": 6.0, "500": 8.0, "1000": 10.0}, False),
])
def test_shrink_rule_is_the_references(cost, want):
    rules = _chip_cost_model()
    assert (rules.SLACK, rules.SHRINK_SLACK) == (1.10, 2.0)
    assert rules.shrink_verdict(cost) is want


def test_path_override_and_cache(tmp_path, monkeypatch):
    path = tmp_path / "model.json"
    path.write_text(json.dumps({"entries": {"cuda": {
        "dense": {"max_width": 4, "shrink": True}}}}))
    monkeypatch.setenv("REPRO_COST_MODEL", str(path))
    cost_model.clear_cache()
    try:
        assert cost_model.model_path() == path
        assert cost_model.pick_max_width("cuda") == 4
        assert cost_model.pick_shrink("cuda") is True
        path.write_text(json.dumps({"entries": {}}))
        assert cost_model.pick_max_width("cuda") == 4      # cached parse
        cost_model.clear_cache()
        assert cost_model.pick_max_width("cuda") == 0      # the fallback
        assert cost_model.load(tmp_path / "none.json") is None
    finally:
        monkeypatch.delenv("REPRO_COST_MODEL")
        cost_model.clear_cache()


@pytest.mark.parametrize("kind", ["dense", "pallas_rbf"])
def test_cpu_pool_takes_the_files_verdicts(kind):
    X = torch.rand(40, 3, dtype=torch.float64)
    source = DenseKernel(X @ X.T) if kind == "dense" else PallasRBF(X, 0.5)
    pool = LanePool({"s": source}, torch.ones(40, dtype=torch.float64),
                    wss="1" if kind == "pallas_rbf" else "2",
                    max_width=None, shrink_every="auto")
    assert pool.max_width == cost_model.pick_max_width("cpu", (kind,)) == 1
    assert bool(pool.shrink_every) is cost_model.pick_shrink("cpu", (kind,))
