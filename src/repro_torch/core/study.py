"""Study API: one declarative lane-graph entry point over the lane pool.

Mirrors ``src/repro/core/study.py``: ``LaneSpec``, ``EvalSpec``, ``Plan``,
``LaneStat``, ``StudyResult``, ``resolve_source_backend``, ``plan_specs``,
the plan validation, ``enroll_plan_lanes``, ``run_plan_evals`` (dense-K and
``rows_at`` groups) and ``run_plan``. A ``Plan`` is a graph of
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
``shrink_on_seed``) go to the ``LanePool``. Checkpoints, the static plan
analysis (``StudyResult.analysis`` stays None), support-vector-only
evaluation and the wire format are later slices of the port.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.core import seeding
from repro_torch.device import DTYPE, resolve_device
from repro_torch.svm.engine import SMOResult
from repro_torch.svm.scheduler import LanePool
from repro_torch.svm.smo import init_f
from repro_torch.svm.sources import KernelSpec, is_factory
from repro_torch.svm.svc import bias_from_solution, predict


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
    #: the static plan analysis; None until ``analysis/`` is ported
    analysis: Any = None


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


def enroll_plan_lanes(pool: LanePool, plan: Plan, specs: dict) -> set:
    """Register every plan lane with ``pool``: given results directly,
    dependent lanes with their lazy seed closure, start lanes with their
    state (each may be held by an ``after`` edge). Returns the ids that
    entered pre-solved."""
    pre_done: set = set()
    for spec in plan.lanes:
        if spec.result is not None:
            pool.add_result(spec.id, spec.result)
            pre_done.add(spec.id)
            continue
        key = plan.source_key_of(spec)
        if spec.dep is not None:
            pool.add(spec.id, spec.train_mask, spec.C, source=key,
                     dep=spec.dep,
                     seed_fn=_make_seed_fn(plan, spec, pool.resolve_source),
                     max_iter=spec.max_iter, after=spec.after)
        else:
            pool.add(spec.id, spec.train_mask, spec.C, spec.alpha0, spec.f0,
                     source=key, n_iter0=spec.n_iter0,
                     max_iter=spec.max_iter, after=spec.after)
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
            correct = _eval_lanes(lambda g: K[test_idx[g]], y, test_idx,
                                  masks, Cs, res)
        for ev, c in zip(evs, correct):
            evals[ev.lane] = (int(c), t_sz)
    return evals


def run_plan(plan: Plan) -> StudyResult:
    """Execute a ``Plan`` on one ``LanePool`` on the plan's device
    (``cuda`` unless ``plan.device="cpu"``); the lane graph is validated
    at entry."""
    plan = resolve_source_backend(plan_on_device(plan))
    specs = plan_specs(plan)
    _validate_plan(plan, specs)
    pool = LanePool(plan.sources, plan.y, tol=plan.tol, wss=plan.wss,
                    chunk_iters=plan.chunk_iters,
                    lane_quantum=plan.lane_quantum, max_width=plan.max_width,
                    max_resident=plan.max_resident,
                    cache_bytes=plan.cache_bytes,
                    shrink_every=plan.shrink_every,
                    shrink_quantum=plan.shrink_quantum,
                    shrink_caps=plan.shrink_caps,
                    shrink_on_seed=plan.shrink_on_seed)
    pre_done = enroll_plan_lanes(pool, plan, specs)

    t0 = time.perf_counter()
    kt0 = pool.cache.kernel_time
    results = pool.run()
    if plan.device.type == "cuda":
        torch.cuda.synchronize(plan.device)
    # kernel materializations during the run are the cache's kernel_time
    wall = (time.perf_counter() - t0) - (pool.cache.kernel_time - kt0)

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
                       source_stats=pool.cache.stats)
