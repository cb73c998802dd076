"""Pre-execution analysis of a Study ``Plan``: what will this plan make
the card do, and can it do it within the declared budget?

Mirrors ``src/repro/analysis/plan_check.py`` (``PlanRejected``,
``PlanAnalysis``, ``analyze_plan``, ``check_plan``, the antichain and the
thresholds), with the same findings, so both packages' daemons admit and
refuse the same plans:

* **launch-shape enumeration** — the distinct programs the schedule can
  produce. On the card a "program" is a distinct launch shape of the
  chunk kernels — (single or batched, kind, width, cap, n, dtype, wss) —
  not a compile: each is one plan of blocks and one set of stacked
  operands, where the reference's is one XLA compile. Per source, the
  peak concurrent lane count is the maximum antichain of the dep/after
  graph (Dilworth, by a bipartite matching on reachability);
  ``scheduler.possible_widths`` maps it through the width buckets and the
  ``max_width`` cap, and shrinking plans add ``shrink.possible_caps``
  compact capacities a width. ``recompile-storm`` (the reference's name)
  warns past ``STORM_THRESHOLD``.
* **source-cache feasibility** — pinned (dense) sources are always
  resident and every managed source must fit on top of them within
  ``cache_bytes`` (``cache-infeasible``); with ``simulate="bounds"`` the
  schedule simulator (``plan_sim``) replays the plan under the min and max
  bounding oracles, and a schedule that co-holds more than ``cache_bytes``
  is ``cache-infeasible-time`` (an error when even the min schedule does),
  and one that evicts far more often than it has sources is
  ``eviction-thrash``.
* **checkpoint step-key audit** — study records must start at
  ``STUDY_BASE``.
* **dead lanes** — lanes nothing consumes (advisory).

The cost model's key is the plan's device type (``"cpu"``, ``"cuda"``),
where the reference reads ``jax.default_backend()``; ``backend`` overrides
it. Dtypes carry numpy's names (``"float64"``), as in the reference.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.analysis.findings import Report
from repro_torch.svm import cost_model
from repro_torch.svm import shrink as shrink_mod
from repro_torch.svm.scheduler import possible_widths
from repro_torch.svm.sources import dtype_name, is_factory, source_nbytes

#: distinct-program warning threshold: beyond this, one tenant's plan
#: spreads the shared pool over many launch shapes (the reference's: one
#: XLA compile each)
STORM_THRESHOLD = 8

#: antichain computation cap: above this many lanes per source the peak
#: falls back to the lane count (an upper bound) — noted in the analysis
ANTICHAIN_LIMIT = 512

#: max-bound simulation horizon, in chunks per lane: admission must stay
#: cheap, and residency/eviction behaviour is periodic well before this
SIM_HORIZON_CHUNKS = 8

#: eviction-thrash warning: more than this many evictions per managed
#: source over the max-bound schedule means kernels re-materialize
#: repeatedly instead of draining
THRASH_FACTOR = 2


class PlanRejected(ValueError):
    """``check_plan``'s strict rejection. A ``ValueError`` (existing
    callers' except clauses keep working) that carries the full
    :class:`PlanAnalysis`, so an admission gate — the study daemon — can
    put the structured findings on the wire instead of re-parsing the
    rendered message."""

    def __init__(self, message: str, analysis: "PlanAnalysis"):
        super().__init__(message)
        self.analysis = analysis


@dataclasses.dataclass
class PlanAnalysis:
    """The analyzer's answer: distinct program shapes, per-source width
    profile, budget accounting, schedule-simulation summaries (when the
    simulator ran), and the findings report."""
    programs: list[tuple]      # distinct (program, kind, w, cap, n, dtype, wss)
    program_count: int
    per_source: dict           # key -> {kind, n, dtype, peak_width, widths, caps}
    max_width: int             # effective cap the enumeration used
    pinned_bytes: int
    peak_managed_bytes: int    # largest single managed source
    report: Report
    #: ``{"min": ..., "max": ...}`` ScheduleAnalysis.summary_json() dicts
    #: from the bounding simulations (None when ``simulate="off"``)
    sim: dict | None = None

    @property
    def ok(self) -> bool:
        return not self.report.errors

    def to_json(self) -> dict:
        return {"programs": [list(p) for p in self.programs],
                "program_count": self.program_count,
                "per_source": {str(k): v for k, v in
                               self.per_source.items()},
                "max_width": self.max_width,
                "pinned_bytes": self.pinned_bytes,
                "peak_managed_bytes": self.peak_managed_bytes,
                "sim": self.sim,
                "findings": self.report.to_json()["findings"]}


def _max_antichain(nodes: list, prereqs: dict) -> int:
    """Maximum antichain of the DAG over ``nodes`` (``prereqs[v]`` = ids
    v waits on), restricted to ``nodes`` but ordered through the full
    graph: Dilworth — |S| minus a maximum matching on the reachability
    relation, reachability as bitmasks over a topological order."""
    order = _topo(prereqs)
    idx = {v: i for i, v in enumerate(order)}
    reach = [0] * len(order)            # bitmask of ancestors (prereqs*)
    for v in order:
        m = 0
        for p in prereqs.get(v, ()):
            if p in idx:
                m |= reach[idx[p]] | (1 << idx[p])
        reach[idx[v]] = m
    sel = [v for v in nodes if v in idx]
    sel_bit = {v: 1 << idx[v] for v in sel}
    # comparable pairs within the selection: u < v iff u in ancestors(v)
    adj = {v: [u for u in sel
               if u is not v and reach[idx[v]] & sel_bit[u]]
           for v in sel}
    match_l: dict = {}
    match_r: dict = {}
    for v in sel:                        # greedy init (chains match fast)
        for u in adj[v]:
            if u not in match_r:
                match_l[v], match_r[u] = u, v
                break

    def augment(v, seen):
        for u in adj[v]:
            if u in seen:
                continue
            seen.add(u)
            if u not in match_r or augment(match_r[u], seen):
                match_l[v], match_r[u] = u, v
                return True
        return False

    for v in sel:
        if v not in match_l:
            augment(v, set())
    return len(sel) - len(match_l)


def _topo(prereqs: dict) -> list:
    seen: dict = {}
    out: list = []
    for root in prereqs:
        stack = [(root, iter(prereqs.get(root, ())))]
        if root in seen:
            continue
        seen[root] = True
        while stack:
            node, it = stack[-1]
            advanced = False
            for p in it:
                if p in prereqs and p not in seen:
                    seen[p] = True
                    stack.append((p, iter(prereqs.get(p, ()))))
                    advanced = True
                    break
            if not advanced:
                out.append(node)
                stack.pop()
    return out


def plan_device_type(plan) -> str:
    """The cost model's key for a plan: its device's type, ``cuda`` when
    the plan names none (the port's default device)."""
    dev = getattr(plan, "device", None)
    return torch.device("cuda" if dev is None else dev).type


def analyze_plan(plan, *, checkpoint=None, backend=None,
                 storm_threshold: int = STORM_THRESHOLD,
                 context: str = "", simulate: str = "off",
                 sim_horizon: int | None = None) -> PlanAnalysis:
    """Build the pre-execution report for ``plan`` (``backend``: the
    cost model's device type, the plan's by default). Never raises on plan
    content — structural problems (the ``_validate_plan`` surface) come
    back as ``invalid-plan`` error findings, so a daemon can report them
    instead of crashing on them. Pure inspection: no kernel materializes,
    no program compiles.

    ``context`` names the submission the findings belong to (the daemon
    threads ``tenant/plan_id`` here), so multi-tenant rejection logs name
    the offending plan; it never enters finding identity.

    ``simulate="bounds"`` additionally replays the schedule through the
    static simulator (``repro_torch.analysis.plan_sim``) under the min/max
    bounding oracles — ``sim_horizon`` iterations per lane for the max
    bound (default ``SIM_HORIZON_CHUNKS * chunk_iters``) — attaching the
    summaries as ``PlanAnalysis.sim`` and the TIME-RESOLVED findings:
    ``cache-infeasible-time`` when the peak co-resident bytes (pinned +
    managed, over the simulated schedule) exceed ``cache_bytes`` (an
    error when even the min schedule exceeds — no convergence pattern
    stays within the declared budget — a warning when only the max
    does), and ``eviction-thrash`` when the max schedule re-materializes
    kernels far beyond the source count. This is what catches the plan
    the worst-single-source rule admits: each source fits alone, but the
    schedule holds several at once."""
    from repro_torch.core import study   # deferred: study imports this
    backend = backend or plan_device_type(plan)

    report = Report()
    try:
        plan = study.resolve_source_backend(plan)
        specs = {}
        for spec in plan.lanes:
            if spec.id in specs:
                raise ValueError(f"duplicate lane id {spec.id!r}")
            specs[spec.id] = spec
        study._validate_plan(plan, specs)
    except ValueError as e:
        report.add("invalid-plan", "<plan>", "plan", str(e),
                   context=context)
        return PlanAnalysis(programs=[], program_count=0, per_source={},
                            max_width=0, pinned_bytes=0,
                            peak_managed_bytes=0, report=report)

    kinds = {cost_model.source_kind(s) for s in plan.sources.values()}
    max_width = plan.max_width if plan.max_width is not None \
        else cost_model.pick_max_width(backend, kinds=kinds)
    # resolve the shrink knob EXACTLY as the pool does ("auto" goes through
    # the same cost-model verdict), so prediction tracks execution
    shrink_every = getattr(plan, "shrink_every", 0)
    if shrink_every == "auto":
        shrink_every = shrink_mod.DEFAULT_SHRINK_EVERY \
            if cost_model.pick_shrink(backend, kinds=kinds) else 0
    shrink_every = int(shrink_every)

    # ---- compile-shape enumeration --------------------------------------
    solved = [s for s in plan.lanes if s.result is None]
    prereqs = {s.id: [t for t in (s.dep, s.after)
                      if t is not None and specs[t].result is None]
               for s in solved}
    per_source: dict = {}
    programs: set = set()
    for key, entry in plan.sources.items():
        lanes = [s.id for s in solved if plan.source_key_of(s) == key]
        if not lanes:
            continue
        n = int(plan.y_of(key).shape[0])
        dtype = getattr(entry, "dtype", None)
        dtype = "?" if dtype is None else dtype_name(dtype)
        kind = cost_model.source_kind(entry)
        if len(lanes) > ANTICHAIN_LIMIT:
            peak, exact = len(lanes), False
        else:
            peak, exact = _max_antichain(lanes, prereqs), True
        widths = possible_widths(peak, plan.lane_quantum, max_width)
        caps = shrink_mod.possible_caps(
            n, getattr(plan, "shrink_quantum", 128),
            getattr(plan, "shrink_caps", None)) if shrink_every else ()
        for w in widths:
            program = "single" if w == 1 else "batched"
            # cap == n marks the unshrunk program; each smaller cap is the
            # same chunk program traced at the compact shape
            programs.add((program, kind, w, n, n, dtype, plan.wss))
            for c in caps:
                programs.add((program, kind, w, int(c), n, dtype, plan.wss))
        per_source[key] = {"kind": kind, "n": n, "dtype": dtype,
                           "lanes": len(lanes), "peak_width": peak,
                           "peak_exact": exact, "widths": list(widths),
                           "caps": [int(c) for c in caps]}

    if len(programs) > storm_threshold:
        report.add("recompile-storm", "<plan>", "programs",
                   f"schedule can produce {len(programs)} distinct launch "
                   f"shapes (> {storm_threshold}): raise lane_quantum "
                   "or cap max_width to bound them",
                   severity="warn", context=context)

    # ---- SourceCache budget feasibility ---------------------------------
    pinned_bytes = sum(source_nbytes(s) for s in plan.sources.values()
                      if not is_factory(s))
    managed = {k: source_nbytes(s) for k, s in plan.sources.items()
               if is_factory(s)}
    peak_managed = max(managed.values(), default=0)
    if plan.cache_bytes and managed:
        worst = max(managed, key=managed.get)
        if pinned_bytes + managed[worst] > plan.cache_bytes:
            report.add(
                "cache-infeasible", "<plan>", repr(worst),
                f"source {worst!r} needs {managed[worst]} bytes on top of "
                f"{pinned_bytes} pinned bytes, exceeding the declared "
                f"cache_bytes={plan.cache_bytes} budget — no eviction "
                "schedule can admit it within the plan's own contract",
                context=context)
    if plan.max_resident < 0 or plan.cache_bytes < 0:
        report.add("cache-infeasible", "<plan>", "budget",
                   "negative residency budget", context=context)

    # ---- schedule simulation (time-resolved budget findings) -------------
    sim = None
    if simulate not in ("off", "bounds"):
        raise ValueError(f"unknown simulate mode {simulate!r} "
                         "(have 'off', 'bounds')")
    if simulate == "bounds" and not report.errors:
        from repro_torch.analysis import plan_sim
        horizon = int(sim_horizon) if sim_horizon \
            else SIM_HORIZON_CHUNKS * int(plan.chunk_iters)
        try:
            lo = plan_sim.simulate_plan(
                plan, oracle=plan_sim.BoundOracle("min"), backend=backend)
            hi = plan_sim.simulate_plan(
                plan, oracle=plan_sim.BoundOracle("max", horizon=horizon),
                backend=backend)
        except Exception as e:   # admission must degrade, not crash
            report.add("sim-error", "<plan>", "schedule",
                       f"schedule simulation failed: {e}", severity="warn",
                       context=context)
        else:
            sim = {"min": lo.summary_json(), "max": hi.summary_json()}
            if plan.cache_bytes:
                for sa, severity in ((lo, "error"), (hi, "warn")):
                    if sa.peak_resident_bytes > plan.cache_bytes:
                        report.add(
                            "cache-infeasible-time", "<plan>", "schedule",
                            f"simulated schedule ({sa.oracle} oracle) "
                            f"co-holds {sa.peak_resident_bytes} resident "
                            f"bytes (pinned + managed), exceeding the "
                            f"declared cache_bytes={plan.cache_bytes} "
                            "budget — every source fits alone, but the "
                            "schedule the pool will execute does not",
                            severity=severity, context=context)
                        break
            if managed and hi.evictions > THRASH_FACTOR * len(managed):
                report.add(
                    "eviction-thrash", "<plan>", "schedule",
                    f"max-bound schedule evicts {hi.evictions} times for "
                    f"{len(managed)} managed sources — kernels "
                    "re-materialize instead of draining; raise the "
                    "residency budget or narrow max_width",
                    severity="warn", context=context)

    # ---- checkpoint step-key ranges -------------------------------------
    if checkpoint is not None:
        base = int(getattr(checkpoint, "base_step", study.STUDY_BASE))
        if base < study.STUDY_BASE:
            zone = "mid-fold (< 1e12)" if base < 1_000_000 ** 2 \
                else "batch ([1e12, 2e12))"
            report.add(
                "checkpoint-key-collision", "<plan>", "base_step",
                f"study base_step {base} lands in the {zone} record range; "
                f"study records must start at STUDY_BASE "
                f"({study.STUDY_BASE}) to share a checkpoint directory "
                "with fold and batch records", context=context)

    # ---- dead lanes ------------------------------------------------------
    consumed = {ev.lane for ev in plan.evals}
    consumed |= {t for s in plan.lanes for t in (s.dep, s.after)
                 if t is not None}
    for spec in plan.lanes:
        if spec.id not in consumed:
            what = "given result" if spec.result is not None else "result"
            report.add("lane-unobserved", "<plan>", repr(spec.id),
                       f"lane {spec.id!r}: {what} is never evaluated and "
                       "no lane depends on it (mis-keyed EvalSpec, or "
                       "consumed only via on_result/StudyResult)",
                       severity="warn", context=context)

    return PlanAnalysis(programs=sorted(programs),
                        program_count=len(programs),
                        per_source=per_source, max_width=max_width,
                        pinned_bytes=int(pinned_bytes),
                        peak_managed_bytes=int(peak_managed),
                        report=report, sim=sim)


def check_plan(plan, *, checkpoint=None, backend=None,
               context: str = "", simulate: str = "bounds",
               sim_horizon: int | None = None) -> PlanAnalysis:
    """Strict-mode analysis: raise :class:`PlanRejected` (a
    ``ValueError`` carrying the analysis) on any error-severity finding —
    the admission gate the study daemon calls verbatim; returns the
    analysis otherwise. Strict mode runs the schedule simulator by
    default (``simulate="bounds"``): admission holds the plan to the
    TIME-RESOLVED budget, not just the worst single source."""
    pa = analyze_plan(plan, checkpoint=checkpoint, backend=backend,
                      context=context, simulate=simulate,
                      sim_horizon=sim_horizon)
    if pa.report.errors:
        raise PlanRejected(
            "plan rejected by static analysis:\n"
            + "\n".join(f.render() for f in pa.report.errors), pa)
    return pa
