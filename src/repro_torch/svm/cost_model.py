"""The lane pool's width and shrink verdicts per (device type, source
kind).

Mirrors ``src/repro/svm/cost_model.py`` (``DEFAULT_PATH``, ``model_path``
with its ``REPRO_COST_MODEL`` override, ``clear_cache``, ``load`` with its
per-path cache, ``source_kind``, ``fallback_max_width``,
``pick_max_width``, ``fallback_shrink`` and ``pick_shrink``), as the
port's own copy. The model is keyed by the torch device type (``"cpu"``,
``"cuda"``) and read from the port's own file,
``results/cost_model_torch.json``, in the reference's schema: its
``cuda`` entry is measured on the card by ``chip_cost_model.py`` (the
reference's sweep, run on the port's pool); its ``cpu`` entry is the
reference's ``results/cost_model.json`` entry, copied verbatim, so the
port's CPU pool takes the reference's CPU verdicts (width 1, dense shrink
off, ``pallas_rbf`` shrink on). A missing file, device type or kind falls
back to the historical verdict: width-1 round-robin on the CPU, no cap (0)
elsewhere; shrinking off on the CPU, on elsewhere.
"""
from __future__ import annotations

import json
import os
import pathlib

#: repo-relative location of the port's measured model
DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[3] \
    / "results" / "cost_model_torch.json"

_CACHE: dict[str, dict | None] = {}


def clear_cache() -> None:
    """Drop every cached parse (a test that rewrites a model file at the
    same path must call this around the swap)."""
    _CACHE.clear()


def model_path() -> pathlib.Path:
    """The model file: ``REPRO_COST_MODEL`` when set, else the port's."""
    return pathlib.Path(os.environ.get("REPRO_COST_MODEL", DEFAULT_PATH))


def load(path=None) -> dict | None:
    """Parse the cost-model file, cached per path; None when absent or
    unreadable (the caller falls back to the default verdict)."""
    p = pathlib.Path(path) if path is not None else model_path()
    key = str(p)
    if key not in _CACHE:
        try:
            with open(p) as fh:
                model = json.load(fh)
            _CACHE[key] = model if isinstance(model.get("entries"), dict) \
                else None
        except (OSError, ValueError):
            _CACHE[key] = None
    return _CACHE[key]


def source_kind(entry) -> str:
    """Cost-model kind of a pool sources-dict entry (source or spec):
    row-streaming sources dispatch a fused launch per iteration, everything
    else indexes a dense matrix."""
    return "pallas_rbf" if getattr(entry, "streams_rows", False) else "dense"


def fallback_max_width(device_type: str) -> int:
    """The default verdict: width 1 on the CPU, unbounded (0) elsewhere."""
    return 1 if device_type == "cpu" else 0


def pick_max_width(device_type: str, kinds=("dense",), model=None,
                   path=None) -> int:
    """``max_width`` for a pool on ``device_type`` dispatching the given
    source kinds: the smallest nonzero measured cap across kinds, 0
    (unbounded) only when every kind is unbounded; a missing entry takes
    the fallback for the device type."""
    if model is None:
        model = load(path)
    per_device = (model or {}).get("entries", {}).get(device_type, {})
    caps = []
    for kind in set(kinds) or {"dense"}:
        entry = per_device.get(kind)
        if not isinstance(entry, dict) or "max_width" not in entry:
            caps.append(fallback_max_width(device_type))
        else:
            caps.append(int(entry["max_width"]))
    finite = [c for c in caps if c > 0]
    return min(finite) if finite else 0


def fallback_shrink(device_type: str) -> bool:
    """The default shrink verdict: off on the CPU (a width-1 step loop whose
    iteration cost is per-op overhead, not operand bytes), on elsewhere."""
    return device_type != "cpu"


def pick_shrink(device_type: str, kinds=("dense",), model=None,
                path=None) -> bool:
    """Shrink verdict for a pool on ``device_type`` dispatching the given
    source kinds (``shrink_every="auto"``): each kind's measured
    ``shrink`` entry, enabled only when every kind says True; a missing
    entry takes the fallback for the device type."""
    if model is None:
        model = load(path)
    per_device = (model or {}).get("entries", {}).get(device_type, {})
    verdicts = []
    for kind in set(kinds) or {"dense"}:
        entry = per_device.get(kind)
        if not isinstance(entry, dict) or "shrink" not in entry:
            verdicts.append(fallback_shrink(device_type))
        else:
            verdicts.append(bool(entry["shrink"]))
    return all(verdicts)
