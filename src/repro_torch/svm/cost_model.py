"""The lane pool's width and shrink verdicts per (device type, source
kind).

Mirrors ``load``, ``source_kind``, ``fallback_max_width``,
``pick_max_width``, ``fallback_shrink`` and ``pick_shrink`` of
``src/repro/svm/cost_model.py``, as the port's own copy. The model is keyed by the torch device type (``"cpu"``, ``"cuda"``);
it is read from ``results/cost_model.json`` (written by the reference's
``scripts/measure_cost_model.py``, which measured only ``cpu``), and the
port never writes it. A missing device type or kind falls back to the
historical verdict: width-1 round-robin on the CPU, no cap (0) elsewhere;
shrinking off on the CPU, on elsewhere (``shrink_every="auto"``). So the
port's CPU pool round-robins like the reference's on the CPU, and on
``cuda`` the pool dispatches every live lane. A measured ``cuda`` entry
is not in the file yet.
"""
from __future__ import annotations

import json
import pathlib

#: repo-relative location of the measured model
DEFAULT_PATH = pathlib.Path(__file__).resolve().parents[3] \
    / "results" / "cost_model.json"


def load(path=None) -> dict | None:
    """Parse the cost-model file; None when absent or unreadable (the
    caller falls back to the default verdict)."""
    try:
        with open(path if path is not None else DEFAULT_PATH) as fh:
            model = json.load(fh)
    except (OSError, ValueError):
        return None
    return model if isinstance(model.get("entries"), dict) else None


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
