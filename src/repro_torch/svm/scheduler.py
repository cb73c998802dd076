"""Lane pool: multi-source repacked batched dispatch with incremental
admission.

Mirrors ``src/repro/svm/scheduler.py``: the pure helpers ``bucket_width``,
``possible_widths``, ``order_capped``, ``select_capped`` and
``budget_sources`` (verbatim in logic), and ``LanePool``:

* **repacking** — between chunks, converged lanes retire (their state
  finalized into an ``SMOResult`` keyed by lane id) and the live lanes of a
  source are gathered into a compact batch, so device work tracks
  ``sum_h n_iter_h``;
* **source and width bucketing** — one batched chunk per (source, width)
  group; a group's width is rounded up to a multiple of ``lane_quantum``
  (1 and 2 exact) with pad lanes that copy lane 0 with ``done`` set and a
  cap of 0, which the chunk kernels pass through untouched; a group of one
  runs the single-lane chunk;
* **width capping** — ``max_width`` from the cost model
  (``cost_model.py``): width 1 on the CPU (round-robin, source-sticky,
  least-served first), unbounded on ``cuda``;
* **admission** — a lane may start from a given state, or depend on
  another lane's result through ``seed_fn(result) -> (alpha0, f0)``,
  and/or wait on an ``after`` ordering edge;
* **kernel residency** — factory sources (``sources.KernelSpec``)
  materialize through the ``SourceCache`` under its budget, and selection
  is budget-aware;
* **shrinking** (``shrink_every`` > 0, ``svm/shrink.py``) — each lane
  carries a ``LaneShrink`` ledger from admission (seeded lanes start
  compact with ``shrink_on_seed``); lanes group by (source, cap), a shrunk
  lane running its compact subproblem at ``10 * tol``: a group of one runs
  the single-lane chunk over its compact source, wider groups go through
  ``chunk_batched_sources`` (ONE launch over the lanes' stacked compact
  operands on the card), pad lanes done with a cap of 0.
  ``shrink_every=0`` keeps the schedule, and its (source, width) program
  keys, as they were.

Each lane's iterate sequence depends only on its own (source, mask, C,
state), and a done lane passes through a chunk unchanged, so per-lane
results are bitwise those of sequential ``engine.solve`` runs whatever the
packing. The host reads a batch's ``done`` flags once per chunk.

The study service's surface is the reference's too: ``add_source`` /
``remove_source`` / ``remove_lanes`` admit and drop a plan's sources and
lanes in a live pool (an empty pool is legal: the daemon builds it before
any plan, on the ``device`` it is given, ``cuda`` by default); lanes carry
a ``tenant`` tag, and the width-capped selection fair-shares the width
between tenants (``select_capped``), counted in ``tenant_stats``.
``on_result(lane_id, result)`` streams retirements, ``on_lane_chunk(
lane_id, state)`` observes each live lane after its chunks, and
``on_snapshot(pool)`` runs every ``snapshot_every`` chunks;
``snapshot_lanes(only=)`` stacks the admitted and retired lanes' (alpha,
f, n_iter, done), and under shrinking the shrink ledger, in lane-id order,
so a snapshot restores under any packing (``core/study.py``).
``LaneScheduler`` is the single-source facade.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.svm import cost_model
from repro_torch.svm import shrink as shrink_mod
from repro_torch.svm.engine import (EngineState, SMOResult, chunk_batched,
                                    chunk_batched_sources, finalize,
                                    init_state, smo_chunk, stack_lanes,
                                    stack_sources)
from repro_torch.svm.sources import SourceCache


def bucket_width(w: int, quantum: int = 4) -> int:
    """Packed width for ``w`` live lanes: 1 and 2 are exact, wider batches
    round up to the next multiple of ``quantum``."""
    if w <= 2:
        return max(w, 1)
    q = max(int(quantum), 1)
    return -(-w // q) * q


def possible_widths(peak: int, quantum: int = 4,
                    max_width: int = 0) -> tuple[int, ...]:
    """Every distinct packed width the pool can dispatch for a source whose
    live-lane count ranges over 1..``peak`` under a ``max_width`` cap
    (0 = unbounded)."""
    cap = int(peak) if not max_width else min(int(peak), int(max_width))
    return tuple(sorted({bucket_width(w, quantum)
                         for w in range(1, max(cap, 1) + 1)}))


def order_capped(lanes, *, sticky, resident, served, source) -> list:
    """Width-capped dispatch priority: the sticky source's lanes, then
    lanes of resident sources, then the rest; each tier stable-sorted by
    ``served``."""
    stick = [ln for ln in lanes if source(ln) == sticky]
    near = [ln for ln in lanes
            if source(ln) != sticky and resident(source(ln))]
    far = [ln for ln in lanes
           if source(ln) != sticky and not resident(source(ln))]
    return (sorted(stick, key=served) + sorted(near, key=served)
            + sorted(far, key=served))


def select_capped(lanes, *, max_width, sticky, resident, served, source,
                  tenant, tenant_served) -> list:
    """``order_capped`` truncated to ``max_width``; lanes of several
    tenants fair-share the width, tenants interleaved round-robin,
    least-served first."""
    tenants = list(dict.fromkeys(tenant(ln) for ln in lanes))
    order = dict(sticky=sticky, resident=resident, served=served,
                 source=source)
    if len(tenants) <= 1:
        return order_capped(lanes, **order)[:max_width]
    per = {t: order_capped([ln for ln in lanes
                            if tenant(ln) is t or tenant(ln) == t], **order)
           for t in tenants}
    tenants.sort(key=lambda t: tenant_served.get(t, 0))
    out: list = []
    while len(out) < max_width and any(per.values()):
        for t in tenants:
            if per[t] and len(out) < max_width:
                out.append(per[t].pop(0))
    return out


def budget_sources(srcs, *, budgeted, pinned, resident, sticky, nbytes,
                   fits) -> set:
    """Which candidate source keys may dispatch this chunk under the
    residency budget: pinned ones always, managed ones greedily in sticky >
    resident > cold order while ``fits(count, bytes)`` admits them."""
    srcs = list(dict.fromkeys(srcs))
    if not budgeted or len(srcs) <= 1:
        return set(srcs)
    allowed = {s for s in srcs if pinned(s)}
    managed = sorted((s for s in srcs if s not in allowed),
                     key=lambda s: (s != sticky, not resident(s)))
    taken: list = []
    used = 0
    for s in managed:
        nb = nbytes(s)
        if taken and not fits(len(taken) + 1, used + nb):
            break
        taken.append(s)
        used += nb
    return allowed | set(taken)


def snapshot_nbytes(n: int, itemsize: int, lane_count: int,
                    shrink: bool = False) -> int:
    """Estimated bytes of one pool snapshot record (``snapshot_lanes``): per
    lane, ``alpha`` and ``f`` rows (``2 * n * itemsize``), an ``n_iter``
    (8) and a ``done`` flag (1); shrinking pools add the ``active`` mask
    (n), the ``shrunk`` / ``no_shrink`` flags and the int32 ``unshrinks``.
    The schedule simulator prices checkpoint volume with this."""
    per = 2 * int(n) * int(itemsize) + 8 + 1
    if shrink:
        per += int(n) + 1 + 1 + 4
    return int(lane_count) * per


def _sync(*tensors) -> None:
    """Wait for the card (so a host clock times work, not its enqueue)."""
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


@dataclasses.dataclass
class _Lane:
    id: Any
    source: Any                           # key into the pool's sources
    train_mask: Any
    C: float
    max_iter: int
    state: EngineState | None = None      # admitted, not yet retired
    dep: Any = None                       # lane id this lane seeds from
    seed_fn: Callable | None = None       # SMOResult -> (alpha0, f0)
    after: Any = None                     # ordering-only admission edge
    alpha0: Any = None                    # deferred start (held by ``after``)
    f0: Any = None
    n_iter0: int = 0
    result: SMOResult | None = None       # set at retirement
    served: int = 0                       # chunks dispatched (fairness)
    tenant: Any = None                    # fair-share accounting group
    seed_s: float = 0.0                   # admission-transform wall time
    solve_s: float = 0.0                  # dispatch wall time attributed here
    shrink: Any = None                    # shrink.LaneShrink when enabled
    shrink0: Any = None                   # restored ledger (active, flags)


class LanePool:
    """Independent solve lanes over one or more kernel sources, driven to
    convergence by repacked, source-bucketed, incrementally admitted chunk
    dispatch (see the module docstring). ``sources`` maps a key to a
    kernel source or a factory (``sources.KernelSpec``), and may be empty;
    ``y`` is shared or a dict keyed like ``sources``. ``device`` is where
    the lanes run: by default the labels' device, or ``cuda`` for a pool
    built empty (raising without a GPU). ``on_trace(event)`` receives the
    schedule's event tuples (admit, given, pack, dispatch, retire, shares,
    resident, checkpoint, materialize, evict). ``shrink_every``
    (iterations between heuristic evaluations; 0 off, ``"auto"`` the cost
    model's verdict for the device and kinds), ``shrink_quantum`` /
    ``shrink_caps`` (the compact capacities) and ``shrink_on_seed`` (the
    admission handoff) turn on active-set shrinking.
    """

    def __init__(self, sources, y, *, tol: float = 1e-3, wss: str = "2",
                 chunk_iters: int = 2048, lane_quantum: int = 4,
                 max_width: int | None = None, max_resident: int = 0,
                 cache_bytes: int = 0, on_snapshot=None,
                 snapshot_every: int = 1, on_result=None, on_lane_chunk=None,
                 shrink_every: int | str = 0, shrink_quantum: int = 128,
                 shrink_caps=None, shrink_on_seed: bool = True,
                 on_trace=None, device=None):
        if not isinstance(sources, dict):
            raise ValueError("sources must be a {key: source} dict")
        self.sources = dict(sources)
        self._ys = {k: (y[k] if isinstance(y, dict) else y)
                    for k in self.sources}
        kinds = {cost_model.source_kind(s) for s in sources.values()}
        if device is None and self._ys:
            device = next(iter(self._ys.values())).device
        self.device = resolve_device(device)
        for key, yv in self._ys.items():
            self._check_device(key, yv)
        if max_width is None:
            max_width = cost_model.pick_max_width(self.device.type,
                                                  kinds=kinds)
        self.max_width = int(max_width)   # 0 = unbounded
        if shrink_every == "auto":
            shrink_every = shrink_mod.DEFAULT_SHRINK_EVERY \
                if cost_model.pick_shrink(self.device.type, kinds=kinds) \
                else 0
        self.shrink_every = int(shrink_every)
        self.shrink_quantum = int(shrink_quantum)
        self.shrink_caps = tuple(int(c) for c in shrink_caps) \
            if shrink_caps else None
        self.shrink_on_seed = bool(shrink_on_seed)
        self._frac_log: list[float] = []  # (cap or n)/n per lane-dispatch
        if on_snapshot is not None and \
                len({tuple(yv.shape) for yv in self._ys.values()}) > 1:
            # snapshot_lanes stacks every lane's (alpha, f) into one (L, n)
            # tree: fail at construction, not at the first snapshot
            raise ValueError(
                "snapshotting requires every source to share one instance "
                "set (homogeneous y shapes); got "
                f"{sorted({tuple(yv.shape) for yv in self._ys.values()})}")
        self.tol = tol
        self.wss = wss
        self.chunk_iters = int(chunk_iters)
        self.lane_quantum = int(lane_quantum)
        self.on_snapshot = on_snapshot
        self.snapshot_every = max(int(snapshot_every), 1)
        self.on_result = on_result
        self.on_lane_chunk = on_lane_chunk
        self.on_trace = on_trace
        self._lanes: dict[Any, _Lane] = {}
        self._order: list[Any] = []       # insertion order = packing order
        self.results: dict[Any, SMOResult] = {}
        self._tenant_served: dict[Any, int] = {}   # fair-share accounting
        self.seed_time = 0.0              # admission transforms (paper "init.")
        self.chunk_count = 0
        self._width_log: list[tuple[int, int]] = []   # (live, dispatched)
        self._programs: set[tuple] = set()    # (source, width[, cap]) seen
        self._src_live: dict[Any, list] = {}          # key -> [sum, n, peak]
        self._sticky: Any = None          # last dispatched source
        # packed batch per source, rebuilt when the group's membership
        # changes (the old pack is written back to its lanes first)
        self._packed: dict[Any, tuple] = {}  # key -> (ids, payload)
        # stacked compact operands per (source, cap) group under shrinking,
        # rebuilt when the group's lanes or their compact sources change
        self._stacked: dict[Any, tuple] = {}  # gkey -> (width, refs, src, ys)
        # the cache calls back into the pool through weak references: a
        # pool and its cache in a cycle would keep a finished run's kernels
        # alive until a cyclic collection
        pool = weakref.ref(self)
        self.cache = SourceCache(
            self.sources, max_resident=max_resident, cache_bytes=cache_bytes,
            wss=wss, distance=lambda key: pool()._source_distance(key),
            sticky=lambda: pool()._sticky,
            on_evict=lambda key: pool()._on_source_evict(key),
            on_trace=lambda *event: pool()._trace(*event))
        for key, entry in self.sources.items():
            self.cache.check_fused(key, entry)

    def _check_device(self, key, y) -> None:
        if y.device.type != self.device.type:
            raise ValueError(f"source {key!r}: labels on {y.device}, the "
                             f"pool runs on {self.device}")

    def _trace(self, *event) -> None:
        if self.on_trace is not None:
            self.on_trace(tuple(event))

    def y_of(self, source_key):
        return self._ys[source_key]

    def resolve_source(self, source_key):
        """The usable kernel source for ``source_key``, through the
        residency cache."""
        return self.cache.get(source_key)

    def _source_distance(self, source_key) -> int:
        """Unretired lanes of a source: the fewest is evicted first."""
        return sum(1 for lane in self._lanes.values()
                   if lane.source == source_key and lane.result is None)

    def _on_source_evict(self, source_key) -> None:
        if source_key in self._packed:
            self._writeback(source_key)

    def _budget_sources(self, lanes) -> set:
        return budget_sources(
            [ln.source for ln in lanes], budgeted=self.cache.budgeted,
            pinned=self.cache.pinned, resident=self.cache.resident,
            sticky=self._sticky, nbytes=self.cache.nbytes_of,
            fits=self.cache.fits)

    def _source_key(self, source) -> Any:
        if source is not None:
            if source not in self.sources:
                raise ValueError(f"unknown source key {source!r}")
            return source
        if len(self.sources) == 1:
            return next(iter(self.sources))
        raise ValueError("a multi-source pool needs an explicit source key "
                         "per lane")

    # ------------------------------------------------------- source lifecycle

    def add_source(self, key, entry, y) -> None:
        """Admit a source into a live pool (the daemon's per-plan intake):
        the fused/WSS check runs now, a factory stays unmaterialized until
        a dispatch needs it."""
        if key in self.sources:
            raise ValueError(f"duplicate source key {key!r}")
        self._check_device(key, y)
        self.cache.check_fused(key, entry)
        self.sources[key] = entry
        self._ys[key] = y
        self.cache.add_entry(key, entry)

    def remove_source(self, key) -> None:
        """Drop a source whose lanes have all retired; refuses while an
        unretired lane still reads it."""
        live = [ln.id for ln in self._lanes.values()
                if ln.source == key and ln.result is None]
        if live:
            raise ValueError(
                f"source {key!r} still has unretired lanes {live!r}")
        self._packed.pop(key, None)
        for gkey in [g for g in self._stacked
                     if isinstance(g, tuple) and g[0] == key]:
            del self._stacked[gkey]
        if self._sticky == key:
            self._sticky = None
        self.sources.pop(key, None)
        self._ys.pop(key, None)
        self._src_live.pop(key, None)
        self.cache.remove_entry(key)

    def remove_lanes(self, lane_ids) -> None:
        """Forget retired lanes (a drained study leaves the pool); a live
        or pending lane refuses."""
        ids = set(lane_ids)
        for lane_id in ids:
            lane = self._lanes.get(lane_id)
            if lane is not None and lane.result is None:
                raise ValueError(f"lane {lane_id!r} is not retired")
        for lane_id in ids:
            self._lanes.pop(lane_id, None)
            self.results.pop(lane_id, None)
        self._order = [i for i in self._order if i not in ids]

    # ---------------------------------------------------------- lane intake

    def add(self, lane_id, train_mask, C, alpha0=None, f0=None, *,
            source=None, n_iter0: int = 0, max_iter: int = 10_000_000,
            dep=None, seed_fn=None, after=None, shrink0=None,
            tenant=None) -> None:
        """Register a lane: its start point (``alpha0``/``f0``, optionally
        ``n_iter0``) or a dependency (``dep`` + ``seed_fn`` mapping that
        lane's ``SMOResult`` to (alpha0, f0)), admitted when the dependency
        retires. ``after`` holds the lane until that lane retires.
        ``shrink0`` restores a snapshotted shrink ledger, ``(active mask or
        None, no_shrink, unshrinks)``: the lane re-enters its compact
        bucket instead of re-running the admission handoff. ``tenant`` tags
        the lane's fair-share group."""
        if lane_id in self._lanes:
            raise ValueError(f"duplicate lane id {lane_id!r}")
        if (dep is None) == (alpha0 is None):
            raise ValueError("give exactly one of alpha0/f0 or dep/seed_fn")
        if (alpha0 is None) != (f0 is None):
            raise ValueError("alpha0 and f0 must be given together "
                             "(f0 = init_f(K, y, alpha0))")
        if dep is not None and seed_fn is None:
            raise ValueError("a dependent lane needs a seed_fn")
        key = self._source_key(source)
        lane = _Lane(id=lane_id, source=key, train_mask=train_mask, C=C,
                     max_iter=int(max_iter), dep=dep, seed_fn=seed_fn,
                     after=after, shrink0=shrink0, tenant=tenant)
        if alpha0 is not None:
            if after is None:
                lane.state = init_state(self.cache.meta(key), self._ys[key],
                                        train_mask, alpha0, f0,
                                        n_iter0=n_iter0)
                self._attach_shrink(lane, n_iter0)
            else:   # held: built at admission, when ``after`` retires
                lane.alpha0, lane.f0, lane.n_iter0 = alpha0, f0, int(n_iter0)
        self._lanes[lane_id] = lane
        self._order.append(lane_id)
        if lane.state is not None:
            self._trace("admit", lane_id, key)

    def _attach_shrink(self, lane: _Lane, n_iter0: int = 0) -> None:
        """Build a lane's shrink ledger the moment its state exists. A
        restored ledger (``shrink0``) comes first; otherwise the seeding ->
        shrinking handoff evaluates the heuristic on the seeded (alpha0,
        f0), so bound-locked seeded alphas start shrunk."""
        if not self.shrink_every:
            return
        y = self._ys[lane.source]
        lane.shrink = ls = shrink_mod.LaneShrink(
            int(y.shape[0]), every=self.shrink_every,
            quantum=self.shrink_quantum, caps=self.shrink_caps,
            n_iter=n_iter0)
        if lane.shrink0 is not None:
            active, no_shrink, unshrinks = lane.shrink0
            ls.no_shrink = bool(no_shrink)
            ls.unshrinks = int(unshrinks)
            lane.shrink0 = None
            if active is not None:
                active = torch.as_tensor(active, dtype=torch.bool,
                                         device=self.device) \
                    & lane.train_mask.to(torch.bool)
                ls.mark(active, shrink_mod._read_count(active))
            return
        if self.shrink_on_seed:
            shrink_mod.seed_shrink(lane.shrink, y, lane.train_mask, lane.C,
                                   lane.state, tol=self.tol)

    def add_result(self, lane_id, result: SMOResult, *,
                   tenant=None) -> None:
        """Register an already-solved lane: it can seed others but is never
        dispatched."""
        if lane_id in self._lanes:
            raise ValueError(f"duplicate lane id {lane_id!r}")
        lane = _Lane(id=lane_id, source=None, train_mask=None, C=None,
                     max_iter=0, result=result, tenant=tenant)
        self._lanes[lane_id] = lane
        self._order.append(lane_id)
        self.results[lane_id] = result
        self._trace("given", lane_id)

    def lane_times(self, lane_id) -> tuple[float, float]:
        """(seed_s, solve_s): a lane's admission transform, and its share
        of every chunk it was dispatched in."""
        lane = self._lanes[lane_id]
        return lane.seed_s, lane.solve_s

    # ------------------------------------------------------------ scheduling

    def _admit(self) -> None:
        """Admit every pending lane whose edges have retired."""
        for lane_id in self._order:
            lane = self._lanes[lane_id]
            if lane.state is not None or lane.result is not None:
                continue
            if lane.after is not None and lane.after not in self.results:
                continue
            meta, y = self.cache.meta(lane.source), self._ys[lane.source]
            if lane.dep is None:          # explicit start held by ``after``
                lane.state = init_state(meta, y, lane.train_mask, lane.alpha0,
                                        lane.f0, n_iter0=lane.n_iter0)
                lane.alpha0 = lane.f0 = None
                self._attach_shrink(lane, lane.n_iter0)
                self._trace("admit", lane_id, lane.source)
                continue
            if lane.dep not in self.results:
                continue
            # a seed transform may materialize its kernel; that time is
            # kernel time, not seed time
            t0 = time.perf_counter()
            k0 = self.cache.kernel_time
            alpha0, f0 = lane.seed_fn(self.results[lane.dep])
            # used once; a seed closure may hold the pool (its sources), so
            # keeping it would put the pool in a cycle through its lanes
            lane.seed_fn = None
            _sync(alpha0, f0)
            dt = (time.perf_counter() - t0) - (self.cache.kernel_time - k0)
            lane.seed_s += dt
            self.seed_time += dt
            lane.state = init_state(self.cache.meta(lane.source), y,
                                    lane.train_mask, alpha0, f0)
            self._attach_shrink(lane)
            self._trace("admit", lane_id, lane.source)

    def _live(self) -> list[_Lane]:
        return [self._lanes[i] for i in self._order
                if self._lanes[i].state is not None
                and self._lanes[i].result is None]

    def _retire(self, lane: _Lane, result: SMOResult | None = None) -> None:
        lane.result = result if result is not None else finalize(
            lane.state, self._ys[lane.source], lane.train_mask, lane.C,
            self.tol)
        self.results[lane.id] = lane.result
        if self.on_trace is not None:     # int() syncs — only when tracing
            self._trace("retire", lane.id, int(lane.result.n_iter))
        if self.on_result is not None:
            self.on_result(lane.id, lane.result)

    def _pack(self, key, live: list[_Lane]) -> None:
        """Gather a source group's live lanes into a batch of bucketed
        width; pad lanes copy lane 0 with ``done`` set and a cap of 0."""
        width = bucket_width(len(live), self.lane_quantum)
        states = [ln.state for ln in live]
        masks = [ln.train_mask for ln in live]
        Cs = [float(ln.C) for ln in live]
        caps = [ln.max_iter for ln in live]
        dev = live[0].state.alpha.device
        for _ in range(width - len(live)):
            states.append(live[0].state._replace(
                done=torch.ones((), dtype=torch.bool, device=dev)))
            masks.append(live[0].train_mask)
            Cs.append(float(live[0].C))
            caps.append(0)
        payload = (torch.stack(masks),
                   torch.tensor(Cs, dtype=torch.float64, device=dev),
                   torch.tensor(caps, dtype=torch.int64, device=dev),
                   EngineState.stack(states))
        self._packed[key] = (tuple(ln.id for ln in live), payload)
        self._trace("pack", key, tuple(ln.id for ln in live))

    def _writeback(self, key) -> None:
        """Write a source's packed states back into its lanes and drop the
        pack."""
        ids, payload = self._packed.pop(key)
        states = payload[3]
        for i, lane_id in enumerate(ids):
            self._lanes[lane_id].state = states.lane(i)

    def _cap_select(self, selected: list[_Lane]) -> list[_Lane]:
        """The lanes that dispatch this chunk under ``max_width``:
        source-sticky, resident sources next, least-served first; lanes of
        several tenants fair-share the width, least-served tenant first."""
        return select_capped(selected, max_width=self.max_width,
                             sticky=self._sticky,
                             resident=self.cache.resident,
                             served=lambda ln: ln.served,
                             source=lambda ln: ln.source,
                             tenant=lambda ln: ln.tenant,
                             tenant_served=self._tenant_served)

    def run(self) -> dict[Any, SMOResult]:
        """Drive every lane to retirement; returns {lane_id: SMOResult}."""
        while self.step():
            pass
        pending = [i for i in self._order
                   if self._lanes[i].result is None]
        if pending:
            raise RuntimeError(
                f"lanes {pending} wait on dependencies that never "
                "retire (missing or cyclic dep)")
        return dict(self.results)

    def step(self) -> bool:
        """One scheduling round: admit ready lanes, select under the budget
        and width policy, dispatch one chunk per (source, width) group.
        Returns False when nothing is runnable."""
        self._admit()
        live = self._live()
        if not live:
            return False
        selected = live
        if len(self.sources) > 1 and self.cache.budgeted:
            allowed = self._budget_sources(live)
            if len(allowed) < len({ln.source for ln in live}):
                selected = [ln for ln in live if ln.source in allowed]
        if self.max_width and len(selected) > self.max_width:
            selected = self._cap_select(selected)
        for lane in selected:
            lane.served += 1
            self._tenant_served[lane.tenant] = \
                self._tenant_served.get(lane.tenant, 0) + 1
        groups: dict[Any, list[_Lane]] = {}
        for lane in selected:
            # under shrinking, lanes group by (source, cap): only lanes of
            # one cap bucket share a stacked dispatch (same shapes)
            gkey = (lane.source, lane.shrink.cap) if self.shrink_every \
                else lane.source
            groups.setdefault(gkey, []).append(lane)
        if len(self.sources) > 1:
            counts: dict[Any, int] = {}
            for lane in live:
                counts[lane.source] = counts.get(lane.source, 0) + 1
            for key, c in counts.items():
                rec = self._src_live.setdefault(key, [0, 0, 0])
                rec[0] += c
                rec[1] += 1
                rec[2] = max(rec[2], c)
        # affinity follows the chunk's primary group
        self._sticky = selected[0].source
        for gkey in set(self._stacked) - set(groups):
            del self._stacked[gkey]      # a group that no longer runs
        chunk = self.chunk_count
        dispatched = 0
        for gkey, lanes in groups.items():
            width = (1 if len(lanes) == 1
                     else bucket_width(len(lanes), self.lane_quantum))
            dispatched += width
            if self.shrink_every:
                key, cap = gkey
                n = int(self._ys[key].shape[0])
                self._programs.add((key, width, cap or n))
                for lane in lanes:
                    self._frac_log.append((cap or n) / n)
            else:
                key, cap = gkey, 0
                self._programs.add((key, width))
            self._trace("dispatch", chunk, key, cap, width,
                        tuple(ln.id for ln in lanes))
            # a materialization inside the dispatch is kernel time
            t0 = time.perf_counter()
            k0 = self.cache.kernel_time
            if self.shrink_every:
                self._step_shrink(gkey, lanes)
            elif len(lanes) == 1:
                self._step_single(lanes[0])
            else:
                self._step_batched(key, lanes)
            dt = (time.perf_counter() - t0) \
                - (self.cache.kernel_time - k0)
            for lane in lanes:
                lane.solve_s += dt / len(lanes)
        self._width_log.append((len(live), dispatched))
        if self.on_trace is not None:
            if any(ln.tenant is not None for ln in selected):
                shares: dict[Any, int] = {}
                for lane in selected:
                    shares[lane.tenant] = shares.get(lane.tenant, 0) + 1
                self._trace("shares", chunk, tuple(sorted(
                    (repr(t), c) for t, c in shares.items())))
            self._trace("resident", chunk,
                        self.cache.pinned_bytes + self.cache.resident_bytes)
        self.chunk_count += 1
        if self.on_lane_chunk is not None:
            for lane in selected:
                if lane.result is None:
                    self.on_lane_chunk(lane.id, self._lane_state(lane))
        if self.on_snapshot is not None and \
                self.chunk_count % self.snapshot_every == 0:
            if self.on_trace is not None:
                ids = [i for i in self._order
                       if self._lanes[i].state is not None
                       or self._lanes[i].result is not None]
                first = self._lanes[ids[0]]
                ref = (first.result.alpha if first.result is not None
                       else first.state.alpha)
                self._trace("checkpoint", chunk, tuple(ids),
                            snapshot_nbytes(int(ref.shape[0]),
                                            ref.element_size(), len(ids),
                                            bool(self.shrink_every)))
            self.on_snapshot(self)
        return True

    def _step_single(self, lane: _Lane) -> None:
        """Width 1: the single-lane chunk (bitwise ``engine.solve``'s)."""
        cached = self._packed.get(lane.source)
        if cached is not None and lane.id in cached[0]:
            self._writeback(lane.source)
        src, y = self.resolve_source(lane.source), self._ys[lane.source]
        lane.state = smo_chunk(src, y, lane.train_mask, lane.C, lane.state,
                               n_iters=self.chunk_iters, wss=self.wss,
                               tol=self.tol, it_cap=lane.max_iter)
        # a chunk as long as the lane's cap always ends it (run_cv's one
        # chunk a fold): its result (a pure function of its state) is then
        # enqueued behind the chunk, before the host waits for the done
        # flag, so its launches (~0.45 ms of host time) overlap the chunk
        result = None
        if self.chunk_iters >= lane.max_iter:
            result = finalize(lane.state, y, lane.train_mask, lane.C,
                              self.tol)
        if bool(lane.state.done):
            self._retire(lane, result)

    def _step_batched(self, key, lanes: list[_Lane]) -> None:
        """One chunk over one source's selected lanes; a membership change
        writes the old pack back and repacks first."""
        ids = tuple(ln.id for ln in lanes)
        cached = self._packed.get(key)
        if cached is None or cached[0] != ids:
            if cached is not None:
                self._writeback(key)
            self._pack(key, lanes)
        # resolve BEFORE reading the pack: materializing this source may
        # evict another source (flushing ITS pack), never this group's
        src = self.resolve_source(key)
        masks, Cs, caps, states = self._packed[key][1]
        states = chunk_batched(src, self._ys[key], masks, Cs, self.tol, caps,
                               states, self.chunk_iters, self.wss)
        self._packed[key] = (ids, (masks, Cs, caps, states))
        done = states.done[:len(lanes)].tolist()   # one (w,) transfer
        if any(done):
            self._writeback(key)
            for flag, lane in zip(done, lanes):
                if flag:
                    self._retire(lane)

    def _step_shrink(self, gkey, lanes: list[_Lane]) -> None:
        """One chunk over a shrink-enabled (source, cap) group, then each
        lane's shrink lifecycle. Unshrunk lanes (``cap == 0``) run the
        full-set chunks with their cap at the next heuristic boundary;
        shrunk lanes run the same chunks over their compact operands at
        ``10 * tol`` (each lane its own rows: width > 1 goes through
        ``chunk_batched_sources`` over the group's stacked operands, kept
        while its lanes and their compact sources stay the same). States
        are packed fresh every chunk (groups change membership as lanes
        change buckets); the full-state mirror ``lane.state`` is kept
        fresh by ``shrink.advance``."""
        key, cap = gkey
        src, y = self.resolve_source(key), self._ys[key]
        for lane in lanes:
            if lane.shrink.cap and lane.shrink.idx is None:
                lane.shrink.enter(src, y, lane.state)
        it_caps = [ln.shrink.it_cap(ln.shrink.n_iter, ln.max_iter)
                   for ln in lanes]
        if len(lanes) == 1:
            ln = lanes[0]
            if cap == 0:
                ln.state = smo_chunk(src, y, ln.train_mask, ln.C, ln.state,
                                     n_iters=self.chunk_iters, wss=self.wss,
                                     tol=self.tol, it_cap=it_caps[0])
            else:
                ls = ln.shrink
                ls.cstate = smo_chunk(ls.csrc, ls.cy, ls.cmask, ln.C,
                                      ls.cstate, n_iters=self.chunk_iters,
                                      wss=self.wss, tol=10.0 * self.tol,
                                      it_cap=it_caps[0])
        else:
            width = bucket_width(len(lanes), self.lane_quantum)
            pad = width - len(lanes)
            Cs = [float(ln.C) for ln in lanes] + [float(lanes[0].C)] * pad
            it_caps += [0] * pad
            if cap == 0:
                states = [ln.state for ln in lanes]
                masks = [ln.train_mask for ln in lanes]
            else:
                states = [ln.shrink.cstate for ln in lanes]
                masks = [ln.shrink.cmask for ln in lanes]
            states += [states[0]._replace(done=torch.ones_like(
                states[0].done))] * pad
            masks += [masks[0]] * pad
            if cap == 0:
                out = chunk_batched(src, y, torch.stack(masks), Cs, self.tol,
                                    it_caps, EngineState.stack(states),
                                    self.chunk_iters, self.wss)
            else:
                csrc, cys = self._stacked_sources(gkey, lanes, width)
                out = chunk_batched_sources(
                    csrc, cys, torch.stack(masks), Cs, 10.0 * self.tol,
                    it_caps, EngineState.stack(states), self.chunk_iters,
                    self.wss)
            for i, ln in enumerate(lanes):
                if cap == 0:
                    ln.state = out.lane(i)
                else:
                    ln.shrink.cstate = out.lane(i)
        for ln in lanes:
            ln.state, verdict = shrink_mod.advance(
                ln.shrink, src, y, ln.train_mask, ln.C, ln.state,
                tol=self.tol, max_iter=ln.max_iter)
            if verdict == "retire":
                self._retire(ln)

    def _stacked_sources(self, gkey, lanes: list[_Lane], width: int):
        """The group's compact sources and labels stacked along a lane axis
        of ``width`` (``stack_sources``; the pad lanes' slots zeros): the
        last dispatch's while the group's width, lanes and their compact
        sources are the same (held by weak references, so a lane's dropped
        compact source is not kept alive), else built anew."""
        shr = [ln.shrink for ln in lanes]
        hit = self._stacked.pop(gkey, None)   # the old stack goes first
        if hit is not None and hit[0] == width and len(hit[1]) == len(shr) \
                and all(r() is ls.csrc for r, ls in zip(hit[1], shr)):
            self._stacked[gkey] = hit
            return hit[2], hit[3]
        del hit
        csrc = stack_sources([ls.csrc for ls in shr], width)
        cys = stack_lanes([ls.cy for ls in shr], width)
        self._stacked[gkey] = (width, [weakref.ref(ls.csrc) for ls in shr],
                               csrc, cys)
        return csrc, cys

    # ---------------------------------------------------------- observability

    def _lane_state(self, lane: _Lane) -> EngineState:
        """Current state of a live lane, reading through the packed batch."""
        cached = self._packed.get(lane.source)
        if cached is not None and lane.id in cached[0]:
            return cached[1][3].lane(cached[0].index(lane.id))
        return lane.state

    def tenant_stats(self) -> dict:
        """Per-tenant accounting: lane counts by lifecycle stage and the
        fair-share ``served`` counter (lane-chunks dispatched)."""
        stats: dict[Any, dict] = {}

        def rec(t):
            return stats.setdefault(
                t, {"lanes": 0, "live": 0, "pending": 0, "retired": 0,
                    "served": 0})

        for lane in self._lanes.values():
            r = rec(lane.tenant)
            r["lanes"] += 1
            if lane.result is not None:
                r["retired"] += 1
            elif lane.state is not None:
                r["live"] += 1
            else:
                r["pending"] += 1
        for t, n in self._tenant_served.items():
            rec(t)["served"] = n
        return stats

    def snapshot_lanes(self, *, only=None):
        """(lane_ids, tree) of every admitted or retired lane, stacked in
        lane-id (insertion) order, not packed position, so a snapshot
        restores by lane id under any packing. ``tree`` = {alpha (L, n), f
        (L, n), n_iter (L,), done (L,)}; pending lanes are omitted (their
        seeds re-derive from the retired results). ``only`` restricts it
        to a membership test over lane ids (the daemon snapshots each
        study alone). Shrinking pools add the shrink ledger: ``active`` (L,
        n) masks, ``shrunk`` / ``no_shrink`` (L,) flags and the int32
        ``unshrinks`` (L,), so a resume re-enters the exact compact bucket
        under any schedule; a live shrunk lane's mirror has alpha current
        everywhere and f current on its active rows, what re-gathering
        needs."""
        ids, alphas, fs, iters, dones = [], [], [], [], []
        actives, shrunks, noshrinks, unshrinks = [], [], [], []
        for lane_id in self._order:
            if only is not None and lane_id not in only:
                continue
            lane = self._lanes[lane_id]
            if lane.result is not None:
                src, done = lane.result, True
            elif lane.state is not None:
                src, done = self._lane_state(lane), False
            else:
                continue
            ids.append(lane_id)
            alphas.append(src.alpha)
            fs.append(src.f)
            iters.append(src.n_iter)
            dones.append(done)
            if self.shrink_every:
                ls = lane.shrink if lane.result is None else None
                if ls is not None and ls.shrunk:
                    actives.append(ls.active)
                else:
                    actives.append(torch.ones(src.alpha.shape[0],
                                              dtype=torch.bool,
                                              device=src.alpha.device))
                shrunks.append(bool(ls is not None and ls.shrunk))
                noshrinks.append(bool(ls is not None and ls.no_shrink))
                unshrinks.append(0 if ls is None else int(ls.unshrinks))
        if not ids:       # nothing admitted yet
            return [], {}
        tree = {"alpha": torch.stack(alphas), "f": torch.stack(fs),
                "n_iter": torch.stack(iters),
                "done": torch.tensor(dones, dtype=torch.bool)}
        if self.shrink_every:
            tree["active"] = torch.stack(actives)
            tree["shrunk"] = torch.tensor(shrunks, dtype=torch.bool)
            tree["no_shrink"] = torch.tensor(noshrinks, dtype=torch.bool)
            tree["unshrinks"] = torch.tensor(unshrinks, dtype=torch.int32)
        return ids, tree

    @property
    def occupancy(self) -> dict:
        """Schedule shape over the run: runnable lanes per chunk
        (``mean_live_width``), dispatched width summed over the chunk's
        groups (``mean_packed_width``, ``peak_width``), distinct (source,
        width) programs ((source, width, cap) under shrinking, which adds
        ``shrink_lane_chunks``, the lane-dispatches, and
        ``mean_active_frac``, their mean cap / n), and per-source live
        widths for multi-source pools."""
        if not self._width_log:
            return {"chunks": 0, "mean_live_width": 0.0,
                    "mean_packed_width": 0.0, "peak_width": 0,
                    "programs": 0}
        lives = [w for w, _ in self._width_log]
        packed = [p for _, p in self._width_log]
        occ = {"chunks": len(self._width_log),
               "mean_live_width": round(sum(lives) / len(lives), 3),
               "mean_packed_width": round(sum(packed) / len(packed), 3),
               "peak_width": max(packed),
               "programs": len(self._programs)}
        if self.shrink_every:
            occ["shrink_lane_chunks"] = len(self._frac_log)
            occ["mean_active_frac"] = round(
                sum(self._frac_log) / max(len(self._frac_log), 1), 4)
        if len(self.sources) > 1:
            occ["per_source"] = {
                str(key): {"chunks": n,
                           "mean_live_width": round(s / max(n, 1), 3),
                           "peak_live_width": peak}
                for key, (s, n, peak) in self._src_live.items()}
        return occ


class LaneScheduler(LanePool):
    """Single-source facade over ``LanePool``: one kernel source, one label
    vector; lanes omit the source key."""

    _SOLO = "_solo"

    def __init__(self, source, y, **kwargs):
        super().__init__({self._SOLO: source}, y, **kwargs)

    @property
    def source(self):
        return self.resolve_source(self._SOLO)

    @property
    def y(self):
        return self._ys[self._SOLO]
