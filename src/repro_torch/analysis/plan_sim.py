"""Static schedule simulator: abstract interpretation of the LanePool.

Mirrors ``src/repro/analysis/plan_sim.py`` (the oracles, ``dry_run``,
``ScheduleAnalysis``, ``simulate_plans``, ``simulate_plan``,
``render_events``) over the port's pool; its cost model's key is the
plans' device type where the reference reads ``jax.default_backend()``.

``analyze_plan`` (plan_check.py) bounds a plan's *shape* — program set,
worst single source vs the cache budget. What it cannot see is the
schedule over TIME: which kernels are co-resident when, how often the LRU
re-materializes under churn, how many chunks each tenant consumes, how
much checkpoint volume a study writes. This module answers those by
*executing the schedule symbolically*: a deterministic replay of the
``LanePool`` scheduling loop over a ``Plan`` — no kernel materializes, no
program compiles, no solve runs — emitting the same typed event trace the
instrumented live pool emits (``LanePool(on_trace=...)``), so the two can
be asserted equal event-for-event.

**Pure-function contract.** Every decision the live scheduler makes per
chunk is a pure function this module replays verbatim:
``scheduler.order_capped`` / ``select_capped`` (width-capped sticky >
resident > cold priority, multi-tenant round-robin), ``budget_sources``
(per-chunk managed-source budget), ``bucket_width`` (pad bucketing),
``sources.budget_fits`` (THE residency budget rule) and
``sources.pick_victim`` (THE eviction rule). The simulator holds no
policy of its own — drift between prediction and execution is a failed
CI trace assertion (the trace tests), not a silent bug.

**Event grammar** (tuples; ``chunk`` = 0-based scheduling round):

* ``("given", lane_id)`` — pre-solved result registered
* ``("admit", lane_id, source_key)`` — lane state built (edges retired)
* ``("materialize", source_key, nbytes)`` / ``("evict", source_key,
  nbytes)`` — managed residency transitions, in schedule order
* ``("pack", source_key, lane_ids)`` — batched group (re)packed
* ``("dispatch", chunk, source_key, cap, width, lane_ids)`` — one chunk
  program over one (source, cap) group at its bucketed width (cap 0 =
  unshrunk / shrink off)
* ``("retire", lane_id, n_iter)`` — lane done, at its final iteration
  count
* ``("shares", chunk, ((tenant_repr, lanes), ...))`` — per-tenant width
  split of the chunk's selection (multi-tenant pools only)
* ``("resident", chunk, nbytes)`` — end-of-chunk resident watermark
  (pinned + managed)
* ``("checkpoint", chunk, lane_ids, est_bytes)`` — snapshot record
  (``scheduler.snapshot_nbytes`` estimate)

**Iteration oracle.** Convergence is the ONE dynamic input: when each
lane's ``done`` flag first trips. :class:`ExactOracle` replays recorded
per-lane ``n_iter`` (and, for shrink-enabled pools, the recorded
per-dispatch cap sequence — shrink lifecycle decisions are
data-dependent); :func:`oracle_from_trace` derives one from an
instrumented run. :class:`BoundOracle` brackets an unknown schedule:
``"min"`` assumes every lane converges in its first chunk (fewest
dispatches; materialization floor), ``"max"`` runs every lane to a
horizon (dispatch/eviction ceiling). A shrink-enabled plan under a
``BoundOracle`` is approximate — lanes are assumed never to shrink, but
``it_cap`` boundary arithmetic still paces dispatches.

The per-dispatch arithmetic mirrors ``engine._step`` exactly: ``done``
is computed BEFORE the iterate, so a lane whose remaining room is an
exact multiple of ``chunk_iters`` costs one extra zero-advance dispatch
before it retires.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.svm import cost_model
from repro_torch.svm import shrink as shrink_mod
from repro_torch.svm.scheduler import (LanePool, budget_sources,
                                       bucket_width, select_capped,
                                       snapshot_nbytes)
from repro_torch.svm.sources import (budget_fits, is_factory, pick_victim,
                                     source_nbytes)

#: safety valve on simulated scheduling rounds: a max-bound sim of an
#: adversarial plan must not spin the admission gate; truncation only
#: under-reports (``ScheduleAnalysis.truncated`` flags it)
DEFAULT_MAX_CHUNKS = 100_000


def _itemsize(dtype) -> int:
    """Bytes per element of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


class ExactOracle:
    """Exact replay: ``n_iters`` maps lane id -> recorded final
    ``n_iter``. For shrink-enabled pools, ``caps`` maps lane id -> the
    recorded per-dispatch cap sequence (the shrink lifecycle is
    data-dependent, so exact shrink replay needs the recorded caps; the
    lane retires when its sequence is exhausted)."""

    label = "exact"

    def __init__(self, n_iters: dict, caps: dict | None = None):
        self.n_iters = dict(n_iters)
        self.caps = {k: list(v) for k, v in caps.items()} \
            if caps is not None else None

    def target(self, lane_id, max_iter: int) -> int:
        if lane_id not in self.n_iters:
            raise KeyError(f"oracle has no n_iter for lane {lane_id!r}")
        return min(int(self.n_iters[lane_id]), int(max_iter))

    def cap_seq(self, lane_id):
        if self.caps is None:
            return None
        return self.caps.get(lane_id)


class BoundOracle:
    """Bounding oracle: ``"min"`` = every lane converges within its first
    chunk (1 iteration), ``"max"`` = no lane converges before ``horizon``
    iterations (capped by each lane's ``max_iter``)."""

    def __init__(self, mode: str, horizon: int | None = None):
        if mode not in ("min", "max"):
            raise ValueError(f"unknown bound mode {mode!r}")
        if mode == "max" and not horizon:
            raise ValueError("a max-bound oracle needs a horizon")
        self.mode = mode
        self.horizon = int(horizon) if horizon else None
        self.label = f"bound:{mode}"

    def target(self, lane_id, max_iter: int) -> int:
        if self.mode == "min":
            return min(1, int(max_iter))
        return min(self.horizon, int(max_iter))

    def cap_seq(self, lane_id):
        return None


def oracle_from_trace(events, *, shrink: bool = False) -> ExactOracle:
    """Derive the exact oracle from an instrumented trace (``dry_run`` or
    a live ``on_trace`` capture): retire events carry final ``n_iter``;
    with ``shrink``, dispatch events carry each lane's cap sequence."""
    n_iters: dict = {}
    caps: dict = {}
    for ev in events:
        if ev[0] == "dispatch":
            for lid in ev[5]:
                caps.setdefault(lid, []).append(int(ev[3]))
        elif ev[0] == "retire":
            n_iters[ev[1]] = int(ev[2])
    return ExactOracle(n_iters, caps=caps if shrink else None)


def dry_run(plan, *, tenant=None, snapshot_every: int = 0):
    """Instrumented LIVE run of ``plan``'s schedule: a real ``LanePool``
    (kernels materialize, lanes solve) with the trace hook on, enrolled
    and stepped exactly as ``run_plan`` would — but WITHOUT the eval
    phase, which is outside the schedule trace. Returns ``(events,
    pool)``; the trace validates the simulator (and feeds
    :func:`oracle_from_trace`). ``snapshot_every`` > 0 wires a no-op
    snapshot consumer so checkpoint events fire without a checkpoint
    directory."""
    from repro_torch.core import study

    plan = study.resolve_source_backend(study.plan_on_device(plan))
    specs = study.plan_specs(plan)
    study._validate_plan(plan, specs)
    events: list = []
    pool = LanePool(plan.sources, plan.y, tol=plan.tol, wss=plan.wss,
                    chunk_iters=plan.chunk_iters,
                    lane_quantum=plan.lane_quantum, max_width=plan.max_width,
                    max_resident=plan.max_resident,
                    cache_bytes=plan.cache_bytes,
                    on_snapshot=(lambda p: None) if snapshot_every else None,
                    snapshot_every=max(int(snapshot_every), 1),
                    shrink_every=plan.shrink_every,
                    shrink_quantum=plan.shrink_quantum,
                    shrink_caps=plan.shrink_caps,
                    shrink_on_seed=plan.shrink_on_seed,
                    on_trace=events.append, device=plan.device)
    study.enroll_plan_lanes(pool, plan, specs, {}, tenant=tenant)
    pool.run()
    return events, pool


@dataclasses.dataclass
class ScheduleAnalysis:
    """The simulator's answer: the full event trace plus time-resolved
    accounting no shape analysis can produce."""
    oracle: str                    # oracle label the replay used
    chunks: int                    # scheduling rounds
    lane_chunks: int               # lane-dispatches (fairness currency)
    dispatches: dict               # (program, kind, width, cap) -> count
    materializations: int
    evictions: int
    pinned_bytes: int
    peak_resident_bytes: int       # pinned + managed, max over time
    resident_watermarks: list      # per-chunk pinned + managed bytes
    checkpoints: int
    checkpoint_bytes: int          # summed snapshot_nbytes estimates
    tenant_lane_chunks: dict       # tenant repr -> lane-chunks
    n_iters: dict                  # lane id -> simulated final n_iter
    est_dispatch_s: float | None   # cost-model-weighted dispatch estimate
    truncated: bool                # hit max_chunks (under-reports only)
    events: list

    def summary_json(self) -> dict:
        """JSON-able summary WITHOUT the trace (findings and wire
        payloads carry this; the event list can be large)."""
        return {
            "oracle": self.oracle, "chunks": self.chunks,
            "lane_chunks": self.lane_chunks,
            "dispatches": sorted(
                [list(k) + [v] for k, v in self.dispatches.items()]),
            "materializations": self.materializations,
            "evictions": self.evictions,
            "pinned_bytes": self.pinned_bytes,
            "peak_resident_bytes": self.peak_resident_bytes,
            "checkpoints": self.checkpoints,
            "checkpoint_bytes": self.checkpoint_bytes,
            "tenant_lane_chunks": {str(k): v for k, v in
                                   self.tenant_lane_chunks.items()},
            "est_dispatch_s": self.est_dispatch_s,
            "truncated": self.truncated,
            "events": len(self.events)}


class _SimLane:
    """Abstract lane: lifecycle flags plus the iteration counter the
    oracle drives. ``(n, itemsize)`` sizes checkpoint estimates."""

    def __init__(self, id, source, *, tenant=None, dep=None, after=None,
                 held=False, max_iter: int = 10_000_000, n_iter0: int = 0,
                 n: int = 0, itemsize: int = 8):
        self.id = id
        self.source = source
        self.tenant = tenant
        self.dep = dep
        self.after = after
        self.held = held            # explicit start held by ``after``
        self.max_iter = int(max_iter)
        self.m = int(n_iter0)       # iterations so far
        self.n = int(n)
        self.itemsize = int(itemsize)
        self.served = 0
        self.admitted = False
        self.retired = False
        self.given = False
        self.target = None          # min(oracle target, max_iter)
        self.caps = None            # recorded per-dispatch cap sequence
        self.di = 0                 # dispatches so far (caps replay)


class _SimCache:
    """Abstract ``SourceCache``: pinned/managed split, LRU recency as
    list order, residency transitions through the SAME pure rules
    (``budget_fits`` / ``pick_victim``) as the live cache."""

    def __init__(self, sources: dict, nbytes: dict, *, max_resident: int,
                 cache_bytes: int, distance, sticky, on_evict, trace):
        self.pinned = {k for k, e in sources.items() if not is_factory(e)}
        self.nbytes = dict(nbytes)
        self.max_resident = int(max_resident)
        self.cache_bytes = int(cache_bytes)
        self._distance = distance
        self._sticky = sticky
        self._on_evict = on_evict
        self._trace = trace
        self.lru: list = []         # managed resident keys, LRU first
        self.materializations = 0
        self.evictions = 0
        self.pinned_bytes = sum(self.nbytes[k] for k in self.pinned)
        self.peak_bytes = self.pinned_bytes

    @property
    def budgeted(self) -> bool:
        return bool(self.max_resident or self.cache_bytes)

    def fits(self, count: int, nbytes: int) -> bool:
        return budget_fits(count, nbytes, max_resident=self.max_resident,
                           cache_bytes=self.cache_bytes)

    def resident(self, key) -> bool:
        return key in self.pinned or key in self.lru

    def is_pinned(self, key) -> bool:
        return key in self.pinned

    @property
    def managed_bytes(self) -> int:
        return sum(self.nbytes[k] for k in self.lru)

    def get(self, key) -> None:
        """Replay of ``SourceCache.get``: pinned short-circuits, a hit
        refreshes recency, a miss evicts per the budget then
        materializes."""
        if key in self.pinned:
            return
        if key in self.lru:
            self.lru.remove(key)
            self.lru.append(key)
            return
        incoming = self.nbytes[key]
        # the lru guard keeps a single over-budget kernel admissible —
        # the live cache's last-resort rule
        while self.lru and not self.fits(len(self.lru) + 1,
                                         self.managed_bytes + incoming):
            victim = pick_victim(self.lru, sticky=self._sticky(),
                                 distance=self._distance)
            self._on_evict(victim)
            self._trace("evict", victim, self.nbytes[victim])
            self.lru.remove(victim)
            self.evictions += 1
        self.lru.append(key)
        self.materializations += 1
        self._trace("materialize", key, incoming)
        self.peak_bytes = max(self.peak_bytes,
                              self.pinned_bytes + self.managed_bytes)


class _SimPool:
    """The abstract interpreter: ``LanePool.step()``'s control flow with
    every decision routed through the shared pure functions and every
    solve replaced by the oracle's iteration arithmetic."""

    def __init__(self, sources: dict, nbytes: dict, ys: dict,
                 lanes: list, *, chunk_iters: int, lane_quantum: int,
                 max_width: int, max_resident: int, cache_bytes: int,
                 shrink_every: int, oracle, snapshot_every: int = 0,
                 snapshots: bool = False):
        self.sources = dict(sources)
        self.kinds = {k: cost_model.source_kind(e)
                      for k, e in sources.items()}
        self.ys = dict(ys)
        self.lanes = {ln.id: ln for ln in lanes}
        self.order = [ln.id for ln in lanes]
        self.chunk_iters = int(chunk_iters)
        self.lane_quantum = int(lane_quantum)
        self.max_width = int(max_width)
        self.shrink_every = int(shrink_every)
        self.oracle = oracle
        self.snapshot_every = max(int(snapshot_every), 1)
        self.snapshots = bool(snapshots)
        self.events: list = []
        self.sticky = None
        self.chunk_count = 0
        self.tenant_served: dict = {}
        self.packed: dict = {}      # source key -> lane-id tuple
        self.dispatches: dict = {}
        self.lane_chunks = 0
        self.tenant_lane_chunks: dict = {}
        self.iter_weight: dict = {}   # (kind, width) -> lane-iterations
        self.checkpoints = 0
        self.checkpoint_bytes = 0
        self.watermarks: list = []
        self.cache = _SimCache(
            sources, nbytes, max_resident=max_resident,
            cache_bytes=cache_bytes, distance=self._distance,
            sticky=lambda: self.sticky, on_evict=self._on_evict,
            trace=self._trace)
        # registration-order events, exactly as enroll_plan_lanes emits
        for ln in lanes:
            if ln.given:
                self._trace("given", ln.id)
            elif ln.dep is None and not ln.held:
                ln.admitted = True
                self._trace("admit", ln.id, ln.source)

    def _trace(self, *event) -> None:
        self.events.append(tuple(event))

    def _distance(self, key) -> int:
        return sum(1 for ln in self.lanes.values()
                   if ln.source == key and not ln.retired)

    def _on_evict(self, key) -> None:
        self.packed.pop(key, None)

    # ---------------------------------------------------------- lifecycle

    def _admit(self) -> None:
        for lane_id in self.order:
            ln = self.lanes[lane_id]
            if ln.admitted or ln.retired:
                continue
            if ln.after is not None and not self.lanes[ln.after].retired:
                continue
            if ln.dep is None:          # explicit start held by ``after``
                ln.admitted = True
                self._trace("admit", ln.id, ln.source)
                continue
            if not self.lanes[ln.dep].retired:
                continue
            # the study's seed closure resolves the lane's own source at
            # admission (lazy K) — a cache transition in schedule order
            self.cache.get(ln.source)
            ln.admitted = True
            self._trace("admit", ln.id, ln.source)

    def _prepare(self, ln: _SimLane) -> None:
        if ln.target is None:
            ln.caps = self.oracle.cap_seq(ln.id)
            if ln.caps is not None:
                ln.caps = list(ln.caps)
            ln.target = self.oracle.target(ln.id, ln.max_iter)

    def _lane_cap(self, ln: _SimLane) -> int:
        """The lane's current shrink cap for grouping: the recorded
        sequence under exact replay, 0 (never shrunk) under bounds."""
        self._prepare(ln)
        if ln.caps is not None and ln.di < len(ln.caps):
            return ln.caps[ln.di]
        return 0

    def _retire(self, ln: _SimLane, n_iter: int) -> None:
        ln.retired = True
        ln.m = int(n_iter)
        self._trace("retire", ln.id, int(n_iter))

    def _advance(self, ln: _SimLane) -> bool:
        """One dispatch of one lane: ``engine._step`` arithmetic (done
        checked before the iterate). Returns True when the lane retires
        this chunk."""
        self._prepare(ln)
        if ln.caps is not None:
            # exact shrink replay: the recorded cap sequence IS the
            # dispatch schedule; attribute iterations uniformly across it
            # (the per-dispatch split is not recorded)
            if ln.di == 0 and len(ln.caps):
                ln._per = max(self.oracle.n_iters[ln.id], 0) / len(ln.caps)
            self._weigh(ln, getattr(ln, "_per", 0.0))
            ln.di += 1
            if ln.di >= len(ln.caps):
                self._retire(ln, self.oracle.n_iters[ln.id])
                return True
            return False
        if self.shrink_every:
            boundary = (ln.m // self.shrink_every + 1) * self.shrink_every
            tgt = min(ln.target, boundary, ln.max_iter)
        else:
            tgt = ln.target
        room = tgt - ln.m
        done = room < self.chunk_iters
        adv = min(self.chunk_iters, max(room, 0))
        ln.m += adv
        self._weigh(ln, adv)
        if done and ln.m >= ln.target:
            self._retire(ln, ln.m)
            return True
        return False

    def _weigh(self, ln: _SimLane, iters: float) -> None:
        key = (self.kinds[ln.source], self._width)
        self.iter_weight[key] = self.iter_weight.get(key, 0.0) + iters

    # ---------------------------------------------------------- scheduling

    def run(self, max_chunks: int) -> bool:
        """Drive to drain; returns True if truncated at ``max_chunks``."""
        while self.step():
            if self.chunk_count >= max_chunks:
                return True
        pending = [i for i in self.order if not self.lanes[i].retired]
        if pending:
            raise ValueError(
                f"simulated lanes {pending} wait on dependencies that "
                "never retire (missing or cyclic dep)")
        return False

    def step(self) -> bool:
        self._admit()
        live = [self.lanes[i] for i in self.order
                if self.lanes[i].admitted and not self.lanes[i].retired]
        if not live:
            return False
        selected = live
        if len(self.sources) > 1 and self.cache.budgeted:
            allowed = budget_sources(
                [ln.source for ln in live], budgeted=self.cache.budgeted,
                pinned=self.cache.is_pinned, resident=self.cache.resident,
                sticky=self.sticky, nbytes=self.cache.nbytes.__getitem__,
                fits=self.cache.fits)
            if len(allowed) < len({ln.source for ln in live}):
                selected = [ln for ln in live if ln.source in allowed]
        if self.max_width and len(selected) > self.max_width:
            selected = select_capped(
                selected, max_width=self.max_width, sticky=self.sticky,
                resident=self.cache.resident,
                served=lambda ln: ln.served,
                source=lambda ln: ln.source,
                tenant=lambda ln: ln.tenant,
                tenant_served=self.tenant_served)
        for ln in selected:
            ln.served += 1
            self.tenant_served[ln.tenant] = \
                self.tenant_served.get(ln.tenant, 0) + 1
        groups: dict = {}
        for ln in selected:
            gkey = (ln.source, self._lane_cap(ln)) if self.shrink_every \
                else ln.source
            groups.setdefault(gkey, []).append(ln)
        self.sticky = selected[0].source
        chunk = self.chunk_count
        for gkey, lanes in groups.items():
            width = (1 if len(lanes) == 1
                     else bucket_width(len(lanes), self.lane_quantum))
            if self.shrink_every:
                key, cap = gkey
            else:
                key, cap = gkey, 0
            self._trace("dispatch", chunk, key, cap, width,
                        tuple(ln.id for ln in lanes))
            program = "single" if width == 1 else "batched"
            bucket = (program, self.kinds[key], width, cap)
            self.dispatches[bucket] = self.dispatches.get(bucket, 0) + 1
            self.lane_chunks += len(lanes)
            for ln in lanes:
                t = repr(ln.tenant)
                self.tenant_lane_chunks[t] = \
                    self.tenant_lane_chunks.get(t, 0) + 1
            self._width = width
            if self.shrink_every:
                # _step_shrink: resolve FIRST, then the lifecycle
                self.cache.get(key)
                for ln in lanes:
                    self._advance(ln)
            elif len(lanes) == 1:
                ln = lanes[0]
                if ln.id in self.packed.get(key, ()):
                    self.packed.pop(key)            # writeback, no event
                self.cache.get(key)
                self._advance(ln)
            else:
                ids = tuple(ln.id for ln in lanes)
                if self.packed.get(key) != ids:
                    self.packed[key] = ids
                    self._trace("pack", key, ids)
                self.cache.get(key)
                done = [self._advance(ln) for ln in lanes]
                if any(done):
                    self.packed.pop(key, None)      # writeback, no event
        if any(ln.tenant is not None for ln in selected):
            shares: dict = {}
            for ln in selected:
                shares[ln.tenant] = shares.get(ln.tenant, 0) + 1
            self._trace("shares", chunk, tuple(sorted(
                (repr(t), c) for t, c in shares.items())))
        watermark = self.cache.pinned_bytes + self.cache.managed_bytes
        self.watermarks.append(watermark)
        self._trace("resident", chunk, watermark)
        self.chunk_count += 1
        if self.snapshots and self.chunk_count % self.snapshot_every == 0:
            ids = [i for i in self.order
                   if self.lanes[i].admitted or self.lanes[i].given]
            first = self.lanes[ids[0]]
            est = snapshot_nbytes(first.n, first.itemsize, len(ids),
                                  bool(self.shrink_every))
            self.checkpoints += 1
            self.checkpoint_bytes += est
            self._trace("checkpoint", chunk, tuple(ids), est)
        return True


def _estimate_dispatch_s(iter_weight: dict, backend: str | None) -> \
        float | None:
    """Cost-model-weighted dispatch estimate: sum over (kind, width) of
    lane-iterations x the measured ``us_per_lane_iter`` (nearest measured
    width when the exact one is absent). None when the model (or any
    needed kind) is unmeasured."""
    model = cost_model.load()
    if model is None:
        return None
    per_backend = model.get("entries", {}).get(backend, {})
    total_us = 0.0
    for (kind, width), iters in iter_weight.items():
        entry = per_backend.get(kind)
        upli = entry.get("us_per_lane_iter") if isinstance(entry, dict) \
            else None
        if not isinstance(upli, dict) or not upli:
            return None
        wkey = min(upli, key=lambda k: (abs(int(k) - width), int(k)))
        total_us += float(upli[wkey]) * iters
    return round(total_us / 1e6, 6)


def _merged_schedule(plans: list, backend: str | None):
    """One set of pool knobs for a multi-plan pool (the daemon normalizes
    every admitted plan to ITS schedule) — mismatches are an error, and
    ``max_width`` / ``shrink_every`` resolve exactly as the pool does."""
    knobs = [(p.wss, p.chunk_iters, p.lane_quantum, p.max_width,
              p.max_resident, p.cache_bytes, p.shrink_every,
              p.shrink_quantum, p.shrink_caps) for p in plans]
    if len(set(knobs)) > 1:
        raise ValueError("simulate_plans needs every plan to share the "
                         f"pool schedule knobs; got {sorted(set(knobs))}")
    return knobs[0]


def simulate_plans(entries: list, *, oracle, backend=None,
                   snapshot_every: int = 0,
                   max_chunks: int = DEFAULT_MAX_CHUNKS) -> ScheduleAnalysis:
    """Simulate ONE pool serving several (tenant, plan) submissions —
    the daemon's shape: sources merged (shared keys = the daemon's
    dedup), lanes enrolled per plan in submission order, the width
    budget fair-shared across tenants. ``entries`` is a list of
    ``(tenant, plan)``; all plans must share the pool schedule knobs.
    For a solo study, use :func:`simulate_plan`."""
    from repro_torch.analysis.plan_check import plan_device_type
    from repro_torch.core import study

    if backend is None and entries:
        backend = plan_device_type(entries[0][1])
    plans = []
    for tenant, plan in entries:
        plan = study.resolve_source_backend(plan)
        study._validate_plan(plan, study.plan_specs(plan))
        plans.append((tenant, plan))
    (wss, chunk_iters, lane_quantum, max_width, max_resident, cache_bytes,
     shrink_every, shrink_quantum, shrink_caps) = \
        _merged_schedule([p for _, p in plans], backend)
    del wss, shrink_quantum, shrink_caps   # shape-only knobs: no events
    sources: dict = {}
    ys: dict = {}
    for _, plan in plans:
        for key, entry in plan.sources.items():
            if key not in sources:
                sources[key] = entry
                ys[key] = plan.y_of(key)
    kinds = {cost_model.source_kind(e) for e in sources.values()}
    if max_width is None:
        max_width = cost_model.pick_max_width(backend, kinds=kinds)
    if shrink_every == "auto":
        shrink_every = shrink_mod.DEFAULT_SHRINK_EVERY \
            if cost_model.pick_shrink(backend, kinds=kinds) else 0
    nbytes = {k: source_nbytes(e) for k, e in sources.items()}
    lanes: list = []
    for tenant, plan in plans:
        for spec in plan.lanes:
            if spec.result is not None:
                ln = _SimLane(spec.id, None, tenant=tenant)
                ln.given = ln.retired = True
                alpha = spec.result.alpha
                ln.n, ln.itemsize = int(alpha.shape[0]), _itemsize(
                    alpha.dtype)
                lanes.append(ln)
                continue
            key = plan.source_key_of(spec)
            lanes.append(_SimLane(
                spec.id, key, tenant=tenant, dep=spec.dep, after=spec.after,
                held=spec.alpha0 is not None and spec.after is not None,
                max_iter=spec.max_iter, n_iter0=spec.n_iter0,
                n=int(ys[key].shape[0]),
                itemsize=_itemsize(sources[key].dtype)))
    pool = _SimPool(sources, nbytes, ys, lanes, chunk_iters=chunk_iters,
                    lane_quantum=lane_quantum, max_width=int(max_width),
                    max_resident=max_resident, cache_bytes=cache_bytes,
                    shrink_every=int(shrink_every), oracle=oracle,
                    snapshot_every=snapshot_every,
                    snapshots=snapshot_every > 0)
    truncated = pool.run(max_chunks)
    return ScheduleAnalysis(
        oracle=oracle.label, chunks=pool.chunk_count,
        lane_chunks=pool.lane_chunks, dispatches=dict(pool.dispatches),
        materializations=pool.cache.materializations,
        evictions=pool.cache.evictions,
        pinned_bytes=pool.cache.pinned_bytes,
        peak_resident_bytes=pool.cache.peak_bytes,
        resident_watermarks=pool.watermarks,
        checkpoints=pool.checkpoints,
        checkpoint_bytes=pool.checkpoint_bytes,
        tenant_lane_chunks=dict(pool.tenant_lane_chunks),
        n_iters={ln.id: ln.m for ln in lanes if ln.retired and not ln.given},
        est_dispatch_s=_estimate_dispatch_s(pool.iter_weight, backend),
        truncated=truncated, events=pool.events)


def simulate_plan(plan, *, oracle, backend=None, tenant=None,
                  snapshot_every: int = 0,
                  max_chunks: int = DEFAULT_MAX_CHUNKS) -> ScheduleAnalysis:
    """Simulate one ``Plan``'s schedule under ``oracle``. The trace is
    event-for-event what ``dry_run(plan)`` records when the oracle is
    exact (CI asserts this); bounding oracles bracket the unknown
    schedule instead."""
    return simulate_plans([(tenant, plan)], oracle=oracle, backend=backend,
                          snapshot_every=snapshot_every,
                          max_chunks=max_chunks)


def render_events(events, limit: int = 0) -> str:
    """Human-readable trace (``scripts/plan_explain.py`` and the CI
    smoke's diff artifact)."""
    lines = [repr(ev) for ev in events]
    if limit and len(lines) > limit:
        lines = lines[:limit] + [f"... ({len(events) - limit} more)"]
    return "\n".join(lines)
