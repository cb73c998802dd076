"""Study API: one declarative lane-graph entry point over the lane pool.

Mirrors ``src/repro/core/study.py``: ``LaneSpec``, ``EvalSpec``, ``Plan``,
``StudyCheckpoint``, ``LaneStat``, ``StudyResult``, the wire format
(``result_to_dict``, ``result_from_dict``, ``plan_to_dict``,
``plan_from_dict``), ``resolve_source_backend``, ``plan_specs``, the plan
validation, ``restore_study_lanes``, ``enroll_plan_lanes``,
``run_plan_evals`` and ``run_plan``. A ``Plan`` is a graph of
``LaneSpec``s over kernel sources plus ``EvalSpec``s; ``run_plan`` moves it
to its device (``cuda`` unless ``Plan.device="cpu"``), runs it on one
``LanePool`` and evaluates it.

Lanes are start lanes (``alpha0``/``f0``, optionally held by an ``after``
edge), dependent lanes (``dep`` + ``transform``, a name in
``seeding.TRANSFORMS``, + ``params``: admitted the moment the dependency
retires, started at ``transform(K, y, C, dep_result, **params)`` with
``f0 = init_f(K, y, alpha0)``, or from the source's streaming ``matvec``
for a kernel-free transform on a K-less source; dependencies may cross
kernel sources), or given lanes (``result``). ``run_cv``, ``run_loo``
and ``run_grid`` declare their protocols as plans for this entry point.
The shrink knobs (``shrink_every``, ``shrink_quantum``, ``shrink_caps``,
``shrink_on_seed``) go to the ``LanePool``; ``sv_eval`` evaluates over the
support vectors alone, gathered at a ``shrink.bucket_cap`` capacity.

Checkpoints: with a ``StudyCheckpoint``, every ``every``-th chunk saves the
admitted and retired lanes' (alpha, f, n_iter, done), and the shrink
ledger under shrinking, stacked in lane-id order at steps from
``STUDY_BASE``; a resumed run restores retired lanes as results and live
ones at their exact state, so it ends bitwise where the uninterrupted run
would, under any schedule shape. ``analysis`` runs the static plan
analyzer (``repro_torch.analysis.plan_check``) first.

The wire format is the reference's byte for byte: a JSON image of the
dataclasses, arrays as ``{"__nd__": 1, dtype, shape, data: base64(raw
bytes)}`` with numpy dtype names, so a plan built from the same arrays
serializes to the same JSON in either package. ``plan_from_dict`` rejects
unknown transform names and source kinds and non-finite C, gamma and tol
at parse time. The wire carries no device: whoever parses a plan sets
``Plan.device`` (the study daemon, its own).
"""
from __future__ import annotations

import base64
import dataclasses
import math
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import seeding
from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm import shrink as shrink_mod
from repro_torch.svm.engine import (DenseKernel, EngineState, SMOResult,
                                    finalize)
from repro_torch.svm.scheduler import LanePool
from repro_torch.svm.smo import init_f
from repro_torch.svm.sources import KernelSpec, host_array, is_factory
from repro_torch.svm.svc import bias_from_solution, predict

#: study records live above every run_cv fold step (< _FOLD_STRIDE * k)
#: and every run_cv_batched batch step (_FOLD_STRIDE**2 + chunks), so the
#: three record kinds can share one checkpoint directory
STUDY_BASE = 2 * 1_000_000 ** 2


@dataclasses.dataclass
class LaneSpec:
    """One node of the lane graph; ``source`` may be omitted in a
    single-source plan."""
    id: Any
    source: Any = None
    train_mask: Any = None
    C: float | None = None
    alpha0: Any = None
    f0: Any = None
    n_iter0: int = 0
    max_iter: int = 10_000_000
    dep: Any = None
    transform: str | None = None
    params: dict = dataclasses.field(default_factory=dict)
    after: Any = None
    result: Any = None


@dataclasses.dataclass
class EvalSpec:
    """Held-out evaluation of one lane: correct-count of ``predict`` over
    ``test_idx`` rows of the lane's kernel source."""
    lane: Any
    test_idx: Any


@dataclasses.dataclass
class Plan:
    """A declarative study: kernel sources, the lane graph, evaluations,
    the schedule knobs forwarded to the ``LanePool``, and the device.
    Arrays may be numpy or torch; ``run_plan`` moves them to ``device``."""
    sources: dict
    y: Any                                # shared labels, or {source_key: y}
    lanes: list = dataclasses.field(default_factory=list)
    evals: list = dataclasses.field(default_factory=list)
    tol: float = 1e-3
    wss: str = "2"
    chunk_iters: int = 4096
    lane_quantum: int = 4
    max_width: int | None = None
    #: residency budget for factory sources (0 = unbounded)
    max_resident: int = 0
    cache_bytes: int = 0
    #: ``"pallas_rbf"`` rewrites every dense-RBF ``KernelSpec`` to the
    #: row-streaming kind (``PallasRBF``; requires ``wss="1"``)
    source_backend: str = "dense"
    #: active-set shrinking (``svm/shrink.py``): 0 = off (the pool's
    #: schedule as without it), an int = heuristic period in iterations,
    #: ``"auto"`` = the cost model's verdict (``cost_model.pick_shrink``);
    #: ``shrink_quantum`` buckets compact capacities (``shrink_caps``
    #: declares a ladder instead); ``shrink_on_seed`` applies the seeding
    #: -> shrinking handoff at admission
    shrink_every: int | str = 0
    shrink_quantum: int = 128
    shrink_caps: Any = None
    shrink_on_seed: bool = True
    #: support-vector-only evaluation: gather the ``alpha > 0`` rows (at a
    #: ``shrink.bucket_cap`` capacity) before the eval product instead of
    #: multiplying through zero rows; dense-K groups only
    sv_eval: bool = False
    #: None means ``cuda``; ``"cpu"`` runs the plain PyTorch path
    device: Any = None

    def lane(self, id, **kwargs) -> LaneSpec:
        spec = LaneSpec(id=id, **kwargs)
        self.lanes.append(spec)
        return spec

    def evaluate(self, lane, test_idx) -> None:
        self.evals.append(EvalSpec(lane, test_idx))

    def source_key_of(self, spec: LaneSpec) -> Any:
        if spec.source is not None:
            return spec.source
        if len(self.sources) == 1:
            return next(iter(self.sources))
        raise ValueError(f"lane {spec.id!r} needs a source key in a "
                         "multi-source plan")

    def y_of(self, key):
        return self.y[key] if isinstance(self.y, dict) else self.y


@dataclasses.dataclass
class StudyCheckpoint:
    """Checkpoint wiring for ``run_plan``: every ``every``-th chunk, the
    admitted lanes' (alpha, f, n_iter, done) are saved stacked in lane-id
    order under ``retain_class`` at steps counting up from ``base_step``.
    ``meta`` is the run's identity, verified on resume."""
    manager: Any
    every: int = 1
    retain_class: str = "study"
    phase: str = "study_mid"
    base_step: int = STUDY_BASE
    meta: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class LaneStat:
    """Per-lane account: iterations, convergence, the admission transform's
    wall time (the paper's "init."), the lane's share of its chunks, and
    whether it entered pre-solved."""
    n_iter: int
    converged: bool
    seed_s: float
    solve_s: float
    restored: bool = False


@dataclasses.dataclass
class StudyResult:
    results: dict                         # lane id -> SMOResult
    stats: dict                           # lane id -> LaneStat
    evals: dict                           # lane id -> (correct, total)
    occupancy: dict
    seed_time: float
    solve_time: float                     # pool wall time minus seed_time
    restored: frozenset                   # lanes already done at pool start
    source_stats: dict = dataclasses.field(default_factory=dict)
    #: the static plan analysis (``repro_torch.analysis.plan_check``);
    #: None with ``run_plan(..., analysis="off")``
    analysis: Any = None
    #: the fair-share tag the lanes ran under (the daemon's tenant)
    tenant: Any = None


def _tensor(a, dev, dtype=None):
    return None if a is None else torch.as_tensor(a, dtype=dtype, device=dev)


def _source_on(entry, dev):
    """A source or spec with its arrays on ``dev`` (numpy arrays of a
    ``KernelSpec`` become float64 tensors)."""
    if isinstance(entry, KernelSpec) and not isinstance(entry.X,
                                                        torch.Tensor):
        entry = dataclasses.replace(entry, X=torch.as_tensor(entry.X,
                                                             dtype=DTYPE))
    return entry.to(dev)


def _result_on(r, dev) -> SMOResult:
    return SMOResult(*(torch.as_tensor(t, device=dev) for t in r))


def _params_on(params: dict, dev) -> dict:
    """A transform's params with every array (index sets, masks) as a
    tensor on ``dev``; numbers stay as they are."""
    return {k: torch.as_tensor(v, device=dev)
            if isinstance(v, (np.ndarray, torch.Tensor)) else v
            for k, v in params.items()}


def plan_on_device(plan: Plan) -> Plan:
    """The plan with every array as a tensor on its device (``cuda`` unless
    ``plan.device`` says otherwise; raises without a GPU)."""
    dev = resolve_device(plan.device)
    y = ({k: _tensor(v, dev, DTYPE) for k, v in plan.y.items()}
         if isinstance(plan.y, dict) else _tensor(plan.y, dev, DTYPE))
    lanes = [dataclasses.replace(
        s, train_mask=_tensor(s.train_mask, dev, torch.bool),
        alpha0=_tensor(s.alpha0, dev, DTYPE), f0=_tensor(s.f0, dev, DTYPE),
        params=_params_on(s.params, dev),
        result=None if s.result is None else _result_on(s.result, dev))
        for s in plan.lanes]
    return dataclasses.replace(
        plan, sources={k: _source_on(v, dev)
                       for k, v in plan.sources.items()},
        y=y, lanes=lanes, device=dev)


def _freeze(x):
    """JSON round-trips tuples as lists; lane ids are hashable keys, so
    freeze them back on restore."""
    return tuple(_freeze(v) for v in x) if isinstance(x, list) else x


# --------------------------------------------------------------------------
# the wire format (the study service's plan and result images)
# --------------------------------------------------------------------------

#: the source kinds a wire plan may declare
WIRE_SOURCE_KINDS = ("rbf", "linear", "pallas_rbf")


def _nd_to_wire(a) -> dict:
    a = host_array(a)
    return {"__nd__": 1, "dtype": str(a.dtype), "shape": list(a.shape),
            "data": base64.b64encode(a.tobytes()).decode("ascii")}


def _nd_from_wire(d) -> np.ndarray:
    a = np.frombuffer(base64.b64decode(d["data"]), dtype=np.dtype(d["dtype"]))
    return a.reshape([int(s) for s in d["shape"]]).copy()


def _to_wire(v):
    """JSON-encodable image of a plan field value: arrays and tensors via
    the nd codec, tuples as lists (re-frozen on parse), numpy scalars
    unboxed."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (np.bool_, np.integer, np.floating)):
        return v.item()
    if isinstance(v, (np.ndarray, torch.Tensor)):
        return _nd_to_wire(v)
    if isinstance(v, (list, tuple)):
        return [_to_wire(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _to_wire(val) for k, val in v.items()}
    raise TypeError(f"cannot serialize {type(v).__name__!r} value {v!r}")


def _from_wire(v):
    """Inverse of ``_to_wire``; lists come back as tuples (wire lists only
    occur where hashability matters: ids, params, shrink_caps)."""
    if isinstance(v, dict):
        if v.get("__nd__") == 1:
            return _nd_from_wire(v)
        return {k: _from_wire(val) for k, val in v.items()}
    if isinstance(v, list):
        return tuple(_from_wire(x) for x in v)
    return v


def _check_finite(value, what: str):
    """Parse-time gate: a NaN or infinite C, gamma or tol would pass every
    structural check and then poison a shared pool's solves."""
    if value is None:
        return None
    value = float(value)
    if not math.isfinite(value):
        raise ValueError(f"{what}: non-finite value {value!r}")
    return value


def _host_tensor(d) -> torch.Tensor:
    return torch.from_numpy(_nd_from_wire(d))


def result_to_dict(r: SMOResult) -> dict:
    """Wire image of an ``SMOResult`` (arrays bit for bit, scalars as JSON
    numbers)."""
    return {"alpha": _nd_to_wire(r.alpha), "f": _nd_to_wire(r.f),
            "n_iter": int(r.n_iter), "converged": bool(r.converged),
            "b_up": float(r.b_up), "b_low": float(r.b_low)}


def result_from_dict(d: dict) -> SMOResult:
    """The ``SMOResult`` of a wire image, as host tensors."""
    return SMOResult(
        alpha=_host_tensor(d["alpha"]), f=_host_tensor(d["f"]),
        n_iter=torch.tensor(int(d["n_iter"]), dtype=torch.int64),
        converged=torch.tensor(bool(d["converged"])),
        b_up=torch.tensor(float(d["b_up"]), dtype=DTYPE),
        b_low=torch.tensor(float(d["b_low"]), dtype=DTYPE))


def _source_to_wire(key, entry) -> dict:
    if isinstance(entry, KernelSpec):
        return {"kind_tag": "spec", "X": _nd_to_wire(entry.X),
                "gamma": float(entry.gamma), "kind": entry.kind,
                "backend": entry.backend,
                "n": None if entry.n is None else int(entry.n)}
    K = getattr(entry, "K", None)
    if K is not None and not is_factory(entry):
        return {"kind_tag": "dense", "K": _nd_to_wire(K)}
    raise TypeError(
        f"source {key!r}: only KernelSpec and dense-K sources serialize "
        f"(got {type(entry).__name__!r}); opaque sources cannot cross the "
        "wire")


def _source_from_wire(key, d: dict):
    tag = d.get("kind_tag")
    if tag == "dense":
        return DenseKernel(_host_tensor(d["K"]))
    if tag != "spec":
        raise ValueError(f"source {key!r}: unknown source entry tag "
                         f"{tag!r} (have 'spec', 'dense')")
    kind = d.get("kind")
    if kind not in WIRE_SOURCE_KINDS:
        raise ValueError(f"source {key!r}: unknown source kind {kind!r} "
                         f"(have {sorted(WIRE_SOURCE_KINDS)})")
    gamma = _check_finite(d.get("gamma", 1.0), f"source {key!r}: gamma")
    return KernelSpec(_host_tensor(d["X"]), gamma=gamma, kind=kind,
                      backend=d.get("backend", "jnp"),
                      n=None if d.get("n") is None else int(d["n"]))


def plan_to_dict(plan: Plan) -> dict:
    """JSON-encodable image of a ``Plan`` (its ``device`` stays behind).
    Source and y keys ride as ``[key, value]`` pairs (JSON objects cannot
    key by tuple or float); ``plan_from_dict`` re-freezes them."""
    y = plan.y
    y_wire = {"__ymap__": 1,
              "items": [[_to_wire(k), _nd_to_wire(v)]
                        for k, v in y.items()]} \
        if isinstance(y, dict) else _nd_to_wire(y)
    lanes = []
    for spec in plan.lanes:
        lanes.append({
            "id": _to_wire(spec.id), "source": _to_wire(spec.source),
            "train_mask": None if spec.train_mask is None
            else _nd_to_wire(spec.train_mask),
            "C": None if spec.C is None else float(spec.C),
            "alpha0": None if spec.alpha0 is None
            else _nd_to_wire(spec.alpha0),
            "f0": None if spec.f0 is None else _nd_to_wire(spec.f0),
            "n_iter0": int(spec.n_iter0), "max_iter": int(spec.max_iter),
            "dep": _to_wire(spec.dep), "transform": spec.transform,
            "params": _to_wire(dict(spec.params)),
            "after": _to_wire(spec.after),
            "result": None if spec.result is None
            else result_to_dict(spec.result)})
    return {"__plan__": 1,
            "sources": [[_to_wire(k), _source_to_wire(k, v)]
                        for k, v in plan.sources.items()],
            "y": y_wire,
            "lanes": lanes,
            "evals": [[_to_wire(ev.lane), _nd_to_wire(ev.test_idx)]
                      for ev in plan.evals],
            "tol": float(plan.tol), "wss": plan.wss,
            "chunk_iters": int(plan.chunk_iters),
            "lane_quantum": int(plan.lane_quantum),
            "max_width": None if plan.max_width is None
            else int(plan.max_width),
            "max_resident": int(plan.max_resident),
            "cache_bytes": int(plan.cache_bytes),
            "source_backend": plan.source_backend,
            "shrink_every": plan.shrink_every,
            "shrink_quantum": int(plan.shrink_quantum),
            "shrink_caps": _to_wire(plan.shrink_caps),
            "shrink_on_seed": bool(plan.shrink_on_seed),
            "sv_eval": bool(plan.sv_eval)}


def plan_from_dict(d: dict, device=None) -> Plan:
    """Parse a wire plan onto host tensors, for ``device``, rejecting
    hostile content at parse time: unknown transform names and source
    kinds, and non-finite C, gamma or tol, raise the errors
    ``_validate_plan`` uses, before any object that could reach a pool
    exists. Structural rules (edge targets, cycles, duplicate ids) stay
    ``_validate_plan``'s, which admission runs through ``check_plan``."""
    if not isinstance(d, dict) or d.get("__plan__") != 1:
        raise ValueError("not a wire plan (missing '__plan__': 1)")
    sources = {}
    for key_w, entry_w in d.get("sources", ()):
        key = _from_wire(key_w)
        if key in sources:
            raise ValueError(f"duplicate source key {key!r}")
        sources[key] = _source_from_wire(key, entry_w)
    y_w = d.get("y")
    if isinstance(y_w, dict) and y_w.get("__ymap__") == 1:
        y = {_from_wire(k): _host_tensor(v) for k, v in y_w["items"]}
    else:
        y = _host_tensor(y_w)
    tol = _check_finite(d.get("tol", 1e-3), "tol")
    if tol <= 0:
        raise ValueError(f"tol: non-positive value {tol!r}")
    lanes = []
    for lw in d.get("lanes", ()):
        lid = _from_wire(lw.get("id"))
        transform = lw.get("transform")
        if transform is not None and transform not in seeding.TRANSFORMS:
            raise ValueError(f"lane {lid!r}: unknown transform "
                             f"{transform!r} (have "
                             f"{sorted(seeding.TRANSFORMS)})")
        C = _check_finite(lw.get("C"), f"lane {lid!r}: C")
        params = _from_wire(lw.get("params") or {})
        for pk, pv in params.items():
            if isinstance(pv, float):
                _check_finite(pv, f"lane {lid!r}: params[{pk!r}]")
        lanes.append(LaneSpec(
            id=lid, source=_from_wire(lw.get("source")),
            train_mask=None if lw.get("train_mask") is None
            else _host_tensor(lw["train_mask"]),
            C=C,
            alpha0=None if lw.get("alpha0") is None
            else _host_tensor(lw["alpha0"]),
            f0=None if lw.get("f0") is None else _host_tensor(lw["f0"]),
            n_iter0=int(lw.get("n_iter0", 0)),
            max_iter=int(lw.get("max_iter", 10_000_000)),
            dep=_from_wire(lw.get("dep")), transform=transform,
            params=params, after=_from_wire(lw.get("after")),
            result=None if lw.get("result") is None
            else result_from_dict(lw["result"])))
    evals = [EvalSpec(_from_wire(lane_w), _nd_from_wire(idx_w))
             for lane_w, idx_w in d.get("evals", ())]
    shrink_every = d.get("shrink_every", 0)
    if shrink_every != "auto":
        shrink_every = int(shrink_every)
    return Plan(sources=sources, y=y, lanes=lanes, evals=evals,
                tol=tol, wss=str(d.get("wss", "2")),
                chunk_iters=int(d.get("chunk_iters", 4096)),
                lane_quantum=int(d.get("lane_quantum", 4)),
                max_width=None if d.get("max_width") is None
                else int(d["max_width"]),
                max_resident=int(d.get("max_resident", 0)),
                cache_bytes=int(d.get("cache_bytes", 0)),
                source_backend=str(d.get("source_backend", "dense")),
                shrink_every=shrink_every,
                shrink_quantum=int(d.get("shrink_quantum", 128)),
                shrink_caps=_from_wire(d.get("shrink_caps")),
                shrink_on_seed=bool(d.get("shrink_on_seed", True)),
                sv_eval=bool(d.get("sv_eval", False)), device=device)


def _make_seed_fn(plan: Plan, spec: LaneSpec, resolve):
    """The pool-facing seed closure of a dependent lane. ``resolve`` maps a
    source key to a usable source at call time (the pool's residency
    cache), so a factory source materializes only when a lane of its seeds.
    """
    fn = seeding.TRANSFORMS[spec.transform]
    key = plan.source_key_of(spec)
    y, C, params = plan.y_of(key), spec.C, dict(spec.params)

    def seed(prev):
        source = resolve(key)
        K = getattr(source, "K", None)
        if K is None:
            # kernel-free transforms never touch K; f0 comes from the
            # source's streaming matvec instead of the dense init_f
            if getattr(fn, "kernel_free", False) and \
                    callable(getattr(source, "matvec", None)):
                alpha0 = fn(None, y, C, prev, **params)
                return alpha0, source.matvec(alpha0 * y) - y
            raise ValueError(f"lane {spec.id!r}: transform "
                             f"{spec.transform!r} needs a dense kernel "
                             f"source (source {key!r} has no K)")
        alpha0 = fn(K, y, C, prev, **params)
        return alpha0, init_f(K, y, alpha0)

    return seed


def _check_dense(plan: Plan, lane_id, key, what: str,
                 transform: str | None = None) -> None:
    """Seed transforms and evaluations need a dense K, unless the source
    supports the K-less alternative: kernel-free transforms run off a
    streaming ``matvec``, evaluations off a ``rows_at`` row slab. Checkable
    at entry for an already-usable source; factory entries are checked
    when they resolve."""
    entry = plan.sources[key]
    if is_factory(entry) or getattr(entry, "K", None) is not None:
        return
    if transform is not None:
        fn = seeding.TRANSFORMS[transform]
        if getattr(fn, "kernel_free", False) and \
                callable(getattr(entry, "matvec", None)):
            return
    elif callable(getattr(entry, "rows_at", None)):
        return
    raise ValueError(f"lane {lane_id!r}: {what} a dense kernel "
                     f"source (source {key!r} has no K)")


def _validate_plan(plan: Plan, specs: dict) -> None:
    """Fail fast, by name, on a malformed lane graph: unknown source keys,
    edges to undeclared lanes, unknown transform names, transforms and
    evaluations that need a dense K on a K-less source, and dep/after
    cycles."""
    for spec in plan.lanes:
        if spec.source is not None and spec.source not in plan.sources:
            raise ValueError(f"lane {spec.id!r}: unknown source key "
                             f"{spec.source!r} (plan has "
                             f"{sorted(map(repr, plan.sources))})")
        for edge, target in (("dep", spec.dep), ("after", spec.after)):
            if target is not None and target not in specs:
                raise ValueError(
                    f"lane {spec.id!r}: {edge} edge targets undeclared "
                    f"lane {target!r}")
        if spec.dep is not None:
            if spec.transform not in seeding.TRANSFORMS:
                raise ValueError(f"lane {spec.id!r}: unknown transform "
                                 f"{spec.transform!r} (have "
                                 f"{sorted(seeding.TRANSFORMS)})")
            _check_dense(plan, spec.id, plan.source_key_of(spec),
                         f"transform {spec.transform!r} needs",
                         transform=spec.transform)
    for ev in plan.evals:
        if ev.lane not in specs:
            raise ValueError(f"EvalSpec targets undeclared lane {ev.lane!r}")
        _check_dense(plan, ev.lane, plan.source_key_of(specs[ev.lane]),
                     "evaluation needs")
    # cycle check over the admission edges: iterative three-color DFS
    edges = {spec.id: [t for t in (spec.dep, spec.after)
                       if t is not None and specs[t].result is None]
             for spec in plan.lanes if spec.result is None}
    state: dict = {}                       # id -> "on_path" | "done"
    for root in edges:
        if root in state:
            continue
        stack = [(root, iter(edges.get(root, ())))]
        state[root] = "on_path"
        while stack:
            node, it = stack[-1]
            for target in it:
                if state.get(target) == "on_path":
                    path = [n for n, _ in stack]
                    cycle = path[path.index(target):] + [target]
                    raise ValueError(
                        "lane graph has a dep/after cycle: "
                        + " -> ".join(repr(n) for n in cycle))
                if target not in state:
                    state[target] = "on_path"
                    stack.append((target, iter(edges.get(target, ()))))
                    break
            else:
                state[node] = "done"
                stack.pop()


def resolve_source_backend(plan: Plan) -> Plan:
    """Validate ``plan.source_backend`` and apply it: ``"pallas_rbf"``
    rewrites every dense-RBF spec to the row-streaming kind (and requires
    WSS-1)."""
    if plan.source_backend not in ("dense", "pallas_rbf"):
        raise ValueError(f"unknown source_backend {plan.source_backend!r} "
                         "(have 'dense', 'pallas_rbf')")
    if plan.source_backend == "pallas_rbf":
        if plan.wss != "1":
            raise ValueError("source_backend='pallas_rbf' streams both "
                             "kernel rows through the fused step kernel "
                             "and requires WSS-1 (wss='1')")
        plan = dataclasses.replace(plan, sources={
            k: (dataclasses.replace(s, kind="pallas_rbf")
                if isinstance(s, KernelSpec) and s.kind == "rbf" else s)
            for k, s in plan.sources.items()})
    return plan


def plan_specs(plan: Plan) -> dict:
    """``{lane_id: LaneSpec}`` with the duplicate-id check."""
    specs: dict[Any, LaneSpec] = {}
    for spec in plan.lanes:
        if spec.id in specs:
            raise ValueError(f"duplicate lane id {spec.id!r}")
        specs[spec.id] = spec
    return specs


def restore_study_lanes(checkpoint: StudyCheckpoint | None):
    """The newest committed study record, its identity verified against
    ``checkpoint.meta``: ``(step0, {lane_id: (alpha, f, n_iter, done,
    shrink0)})`` with host tensors, empty when there is nothing to resume.
    ``run_plan`` and the daemon resume through this one path."""
    restored: dict[Any, tuple] = {}
    step0 = 0
    if checkpoint is None:
        return step0, restored
    snap = checkpoint.manager.restore_latest_of_class(
        checkpoint.retain_class)
    if snap is None:
        return step0, restored
    step0, tree, extra = snap
    want = {"phase": checkpoint.phase, **checkpoint.meta}
    got = {key: extra.get(key) for key in want}
    if got != want:
        raise ValueError(
            f"checkpoint at step {step0} belongs to run {got}, "
            f"cannot resume it as {want}; point the manager at a "
            "fresh directory or delete the stale checkpoints")
    for i, lid in enumerate(extra["lane_ids"]):
        # the shrink ledger rides along when the snapshotting pool shrank
        shrink0 = None
        if "active" in tree:
            shrink0 = (
                torch.from_numpy(tree["active"][i].copy())
                if bool(tree["shrunk"][i]) else None,
                bool(tree["no_shrink"][i]),
                int(tree["unshrinks"][i]))
        restored[_freeze(lid)] = (
            torch.from_numpy(tree["alpha"][i].copy()),
            torch.from_numpy(tree["f"][i].copy()),
            int(tree["n_iter"][i]), bool(tree["done"][i]), shrink0)
    return step0, restored


def enroll_plan_lanes(pool: LanePool, plan: Plan, specs: dict,
                      restored: dict | None = None, *, tenant=None) -> set:
    """Register every plan lane with ``pool``: given results directly,
    restored lanes from their snapshot state (a retired one re-finalized,
    a live one resumed as it was, its edges history), dependent lanes with
    their lazy seed closure, start lanes with their state (each may be
    held by an ``after`` edge). Returns the ids that entered pre-solved.
    The plan's sources must already be in the pool."""
    pre_done: set = set()
    restored = restored or {}
    dev = pool.device
    for spec in plan.lanes:
        if spec.result is not None:
            pool.add_result(spec.id, spec.result, tenant=tenant)
            pre_done.add(spec.id)
            continue
        key = plan.source_key_of(spec)
        if spec.id in restored:
            alpha, f, n_it, done, shrink0 = restored[spec.id]
            alpha, f = alpha.to(dev), f.to(dev)
            if done:
                # optimality is a pure function of alpha and f, so the
                # re-finalized result is the pre-crash one
                state = EngineState(alpha, f, torch.tensor(
                    n_it, dtype=torch.int64, device=dev),
                    torch.ones((), dtype=torch.bool, device=dev))
                pool.add_result(spec.id, finalize(
                    state, plan.y_of(key), spec.train_mask, spec.C,
                    plan.tol), tenant=tenant)
                pre_done.add(spec.id)
            else:
                pool.add(spec.id, spec.train_mask, spec.C, alpha, f,
                         source=key, n_iter0=n_it, max_iter=spec.max_iter,
                         shrink0=shrink0, tenant=tenant)
        elif spec.dep is not None:
            pool.add(spec.id, spec.train_mask, spec.C, source=key,
                     dep=spec.dep,
                     seed_fn=_make_seed_fn(plan, spec, pool.resolve_source),
                     max_iter=spec.max_iter, after=spec.after, tenant=tenant)
        else:
            pool.add(spec.id, spec.train_mask, spec.C, spec.alpha0, spec.f0,
                     source=key, n_iter0=spec.n_iter0,
                     max_iter=spec.max_iter, after=spec.after, tenant=tenant)
    return pre_done


def _eval_lanes(rows_of, y, test_idx, masks, Cs, res) -> list[int]:
    """Held-out correct-counts of a group of lanes: the sequential CV
    path's bias + predict for each; ``rows_of(g)`` gives lane g's test
    kernel rows."""
    out = []
    for g in range(test_idx.shape[0]):
        r = SMOResult(*(t[g] for t in res))
        b = bias_from_solution(r, y, masks[g], Cs[g])
        pred = predict(rows_of(g), y, r.alpha, b)
        out.append((pred == y[test_idx[g]]).sum())
    return torch.stack(out).tolist()


def _eval_lanes_sv(K, y, test_idx, masks, Cs, res, cap: int) -> list[int]:
    """``_eval_lanes`` over each lane's support vectors alone: its ``alpha
    > 0`` rows placed in ``cap`` slots (``shrink._place``; pads clamp to
    the last row and weigh 0), so the decision product contracts over
    ``cap`` rows instead of n. Same ``>= 0`` convention as ``predict``; the
    sum runs over the support set in another order than the full product,
    so this path agrees with it to rounding, not bitwise (opt-in,
    ``Plan.sv_eval``)."""
    n = y.shape[0]
    slots = torch.arange(cap, device=y.device)
    out = []
    for g in range(test_idx.shape[0]):
        r = SMOResult(*(t[g] for t in res))
        b = bias_from_solution(r, y, masks[g], Cs[g])
        sv = r.alpha > 0
        at = shrink_mod._place(sv, cap).clamp_max(n - 1)
        coef = torch.where(slots < sv.sum(), r.alpha[at] * y[at], 0.0)
        ti = test_idx[g]
        dec = K.index_select(0, ti).index_select(1, at) @ coef + b
        pred = torch.where(dec >= 0, 1.0, -1.0).to(y.dtype)
        out.append((pred == y[ti]).sum())
    return torch.stack(out).tolist()


def run_plan_evals(pool: LanePool, plan: Plan, specs: dict,
                   results: dict) -> dict:
    """The plan's held-out evaluations, one group per (source, test-size);
    resident sources first, so a budgeted cache re-materializes each
    remaining source at most once. A K-less source evaluates from one
    ``rows_at`` row slab per group."""
    evals: dict[Any, tuple[int, int]] = {}
    groups: dict[tuple, list[EvalSpec]] = {}
    for ev in plan.evals:
        spec = specs[ev.lane]
        t_sz = int(np.shape(ev.test_idx)[0])
        groups.setdefault((plan.source_key_of(spec), t_sz), []).append(ev)
    order0 = {}
    for key, _ in groups:
        order0.setdefault(key, len(order0))
    key_rank = {key: (not pool.cache.resident(key), order0[key])
                for key in order0}
    for (key, t_sz), evs in sorted(groups.items(),
                                   key=lambda kv: key_rank[kv[0][0]]):
        source, y = pool.resolve_source(key), plan.y_of(key)
        K = getattr(source, "K", None)
        if K is None and not callable(getattr(source, "rows_at", None)):
            raise ValueError(f"EvalSpec on lane {evs[0].lane!r}: evaluation "
                             f"needs a dense kernel source (source {key!r} "
                             "has no K)")
        res = SMOResult(*(torch.stack(xs) for xs in
                          zip(*[results[ev.lane] for ev in evs])))
        test_idx = torch.as_tensor(np.stack([np.asarray(ev.test_idx)
                                             for ev in evs]),
                                   device=y.device)
        masks = torch.stack([specs[ev.lane].train_mask for ev in evs])
        Cs = [float(specs[ev.lane].C) for ev in evs]
        if K is None:
            K_rows = source.rows_at(test_idx.reshape(-1)).reshape(
                test_idx.shape[0], t_sz, -1)
            correct = _eval_lanes(lambda g: K_rows[g], y, test_idx, masks,
                                  Cs, res)
        else:
            cap_sv = 0
            if plan.sv_eval:
                # one cap a group (its widest lane's support count, rounded
                # up); a cap that would not shrink the product falls back
                n_rows = int(y.shape[0])
                cap_sv = shrink_mod.bucket_cap(
                    int((res.alpha > 0).sum(dim=1).max()), 128)
                if cap_sv >= n_rows:
                    cap_sv = 0
            if cap_sv:
                correct = _eval_lanes_sv(K, y, test_idx, masks, Cs, res,
                                         cap_sv)
            else:
                correct = _eval_lanes(lambda g: K[test_idx[g]], y, test_idx,
                                      masks, Cs, res)
        for ev, c in zip(evs, correct):
            evals[ev.lane] = (int(c), t_sz)
    return evals


def run_plan(plan: Plan, *, checkpoint: StudyCheckpoint | None = None,
             on_result=None, on_lane_chunk=None,
             analysis: str = "advisory", tenant=None) -> StudyResult:
    """Execute a ``Plan`` on one ``LanePool`` on the plan's device
    (``cuda`` unless ``plan.device="cpu"``); the lane graph is validated
    at entry.

    ``on_result(lane_id, result)`` streams each lane's ``SMOResult`` the
    moment it retires; ``on_lane_chunk(lane_id, state)`` observes every
    live lane between its chunks. With ``checkpoint``, the newest
    committed study record is restored first (identity verified against
    ``checkpoint.meta``): retired lanes re-enter as results, live lanes
    resume their exact iterates, pending lanes re-derive their seeds from
    the restored results, bitwise the uninterrupted run under any schedule
    shape. ``analysis``: ``"advisory"`` attaches the static plan analysis
    to ``StudyResult.analysis``, ``"strict"`` raises on its error findings
    before anything dispatches (the daemon's admission gate), ``"off"``
    skips it. ``tenant`` tags the lanes' fair-share group."""
    if analysis not in ("advisory", "strict", "off"):
        raise ValueError(f"unknown analysis mode {analysis!r} "
                         "(have 'advisory', 'strict', 'off')")
    plan = resolve_source_backend(plan_on_device(plan))
    specs = plan_specs(plan)
    _validate_plan(plan, specs)

    plan_analysis = None
    if analysis != "off":
        # deferred: plan_check imports this module for the validation
        from repro_torch.analysis import plan_check
        check = plan_check.check_plan if analysis == "strict" \
            else plan_check.analyze_plan
        plan_analysis = check(plan, checkpoint=checkpoint)

    step0, restored = restore_study_lanes(checkpoint)

    on_snapshot = None
    if checkpoint is not None:
        counter = {"c": max(step0, checkpoint.base_step)}

        def on_snapshot(pool):
            counter["c"] += 1
            lane_ids, tree = pool.snapshot_lanes()
            checkpoint.manager.save(
                counter["c"], tree,
                extra_meta={"phase": checkpoint.phase, "lane_ids": lane_ids,
                            **checkpoint.meta},
                blocking=False, retain_class=checkpoint.retain_class)

    pool = LanePool(plan.sources, plan.y, tol=plan.tol, wss=plan.wss,
                    chunk_iters=plan.chunk_iters,
                    lane_quantum=plan.lane_quantum, max_width=plan.max_width,
                    max_resident=plan.max_resident,
                    cache_bytes=plan.cache_bytes,
                    on_snapshot=on_snapshot,
                    snapshot_every=checkpoint.every if checkpoint else 1,
                    on_result=on_result, on_lane_chunk=on_lane_chunk,
                    shrink_every=plan.shrink_every,
                    shrink_quantum=plan.shrink_quantum,
                    shrink_caps=plan.shrink_caps,
                    shrink_on_seed=plan.shrink_on_seed, device=plan.device)
    pre_done = enroll_plan_lanes(pool, plan, specs, restored, tenant=tenant)

    t0 = time.perf_counter()
    kt0 = pool.cache.kernel_time
    results = pool.run()
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    # kernel materializations during the run are the cache's kernel_time
    wall = (time.perf_counter() - t0) - (pool.cache.kernel_time - kt0)
    if checkpoint is not None:
        checkpoint.manager.wait()

    stats = {}
    for spec in plan.lanes:
        res = results[spec.id]
        seed_s, solve_s = pool.lane_times(spec.id)
        stats[spec.id] = LaneStat(
            n_iter=int(res.n_iter), converged=bool(res.converged),
            seed_s=seed_s, solve_s=solve_s, restored=spec.id in pre_done)

    evals = run_plan_evals(pool, plan, specs, results)

    return StudyResult(results=results, stats=stats, evals=evals,
                       occupancy=pool.occupancy, seed_time=pool.seed_time,
                       solve_time=wall - pool.seed_time,
                       restored=frozenset(pre_done),
                       source_stats=pool.cache.stats,
                       analysis=plan_analysis, tenant=tenant)
