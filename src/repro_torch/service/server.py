"""The study daemon: one shared ``LanePool`` serving many tenants.

Mirrors ``src/repro/service/server.py``: ``StudyService``, the transport-
agnostic core, and ``StudyServer``, its AF_UNIX JSON-lines front end
(``protocol.py``), with the reference's admission, namespacing, dedup,
event stream, snapshots and drain, so a client of either package gets the
same answers from either daemon.

* :class:`StudyService` owns ONE ``LanePool`` and its ``SourceCache`` for
  its lifetime, on ``device`` (``cuda`` unless the caller passes
  ``device="cpu"``; without a GPU it raises), and one **service thread**
  that does every torch operation: plan parsing, admission, enrolment,
  chunk dispatch (``pool.step()``), evaluations, snapshots. Callers hand it
  closures through :meth:`enqueue`; transport threads never touch the
  pool. Per submission the service

  1. parses the wire plan onto host tensors (``plan_from_dict``: hostile
     content dies at parse), holds it to the pool's result-affecting
     contract (tol, wss, shrink settings; the schedule-only knobs are
     set to the pool's, which the pool's bit parity makes safe), and runs
     ``repro_torch.analysis.plan_check.check_plan`` on it: budget
     feasibility against the pool's budget, time-resolved through the
     schedule simulator, the checkpoint-range audit, the launch-shape
     enumeration. All of it runs on the host, before anything is put on
     the card: a refused plan allocates no device memory. The daemon
     hardens ``recompile-storm`` into a refusal, and holds the per-plan
     budgets (``plan_chunk_budget`` lane-chunks, ``plan_bytes_budget``
     peak resident bytes) against the max-bound simulated schedule;
  2. moves the admitted plan to the device and **namespaces** it: lane ids
     become ``("tenant/plan_id", id)`` and source keys become content
     identities, so many tenants' graphs share one pool;
  3. **dedups kernel sources across tenants**: ``sources.source_identity``
     (kind, gamma, backend, n, dtype, X bytes, y bytes), digested on the
     host plan, keys the pool, so two studies on the same data read one
     resident K; sources are refcounted per study and leave the pool with
     the last study that reads them;
  4. streams ``result`` events as lanes retire, snapshots each study's
     lanes every ``snapshot_every`` chunks into a per-(tenant, plan)
     checkpoint directory (``CheckpointManager.namespaced``), and on
     completion runs the plan's evaluations, emits ``done`` and removes
     the study's lanes and sources.

  Fairness is the pool's: lanes carry their tenant, and the width-capped
  selection round-robins tenants, least-served first.

* :class:`StudyServer`: the accept loop plus one framing-only handler
  thread a connection; every reply and event a submission produces is
  emitted from the service thread through the connection's write lock.
  ``shutdown`` drains: in-flight studies flush a snapshot and the daemon
  exits; a client resubmitting the same (tenant, plan_id) to a restarted
  daemon resumes bitwise, under any schedule shape. A daemon killed
  without a drain resumes from its periodic snapshots.
"""
from __future__ import annotations

import dataclasses
import hashlib
import os
import queue
import socket
import threading
import traceback
from typing import Any

from repro_torch.analysis import plan_check
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import study as study_mod
from repro_torch.device import resolve_device
from repro_torch.service import protocol
from repro_torch.svm.scheduler import LanePool
from repro_torch.svm.sources import source_identity

#: result-affecting plan fields that must match the pool (a lane's
#: iterate sequence depends on them: serving a mismatched plan would
#: return other bits than the client's own run_plan)
CONTRACT_FIELDS = ("tol", "wss", "shrink_every", "shrink_quantum",
                   "shrink_caps", "shrink_on_seed")

#: seconds between the accept loop's checks for a stop
ACCEPT_POLL_S = 0.2


@dataclasses.dataclass
class _Study:
    """One admitted submission: the namespaced plan plus routing state."""
    tenant: str
    plan_id: str
    ns: str
    plan: Any                       # namespaced Plan
    specs: dict                     # namespaced {lane_id: LaneSpec}
    emit: Any                       # callable(dict) -> None (wire events)
    lane_ids: set                   # namespaced ids, all lanes
    remaining: set                  # not yet retired
    source_keys: tuple              # distinct pool keys this study refs
    checkpoint: Any                 # StudyCheckpoint | None
    step: int                       # next snapshot step number
    dedup_hits: int
    restored: frozenset = frozenset()


class StudyService:
    """Transport-agnostic daemon core; see the module docstring."""

    def __init__(self, *, tol: float = 1e-3, wss: str = "2",
                 chunk_iters: int = 4096, lane_quantum: int = 4,
                 max_width: int | None = None, max_resident: int = 0,
                 cache_bytes: int = 0, shrink_every: int = 0,
                 shrink_quantum: int = 128, shrink_caps=None,
                 shrink_on_seed: bool = True,
                 checkpoint_root: str | None = None,
                 snapshot_every: int = 1, max_to_keep: int = 3,
                 plan_chunk_budget: int = 0, plan_bytes_budget: int = 0,
                 device=None):
        self.device = resolve_device(device)
        self.pool = LanePool(
            {}, {}, tol=tol, wss=wss, chunk_iters=chunk_iters,
            lane_quantum=lane_quantum, max_width=max_width,
            max_resident=max_resident, cache_bytes=cache_bytes,
            shrink_every=shrink_every, shrink_quantum=shrink_quantum,
            shrink_caps=shrink_caps, shrink_on_seed=shrink_on_seed,
            on_result=self._route_result, device=self.device)
        self.checkpoint_root = checkpoint_root
        self.snapshot_every = max(int(snapshot_every), 1)
        self.max_to_keep = int(max_to_keep)
        #: per-plan admission budgets, 0 = unbounded: held against the
        #: MAX-BOUND simulated schedule at submit time
        self.plan_chunk_budget = int(plan_chunk_budget)
        self.plan_bytes_budget = int(plan_bytes_budget)
        self._studies: dict[str, _Study] = {}
        self._ident_to_key: dict = {}     # source identity -> pool key
        self._key_ident: dict = {}        # pool key -> identity
        self._key_refs: dict = {}         # pool key -> study refcount
        self._cmds: queue.Queue = queue.Queue()
        self._wake = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def enqueue(self, fn) -> None:
        """Hand a closure to the service thread (the ONLY thread that may
        touch the pool)."""
        self._cmds.put(fn)
        self._wake.set()

    def request_stop(self) -> None:
        self._stop.set()
        self._wake.set()

    def join(self, timeout: float | None = None) -> None:
        if self._thread is not None:
            self._thread.join(timeout)

    def _loop(self) -> None:
        while True:
            while True:
                try:
                    fn = self._cmds.get_nowait()
                except queue.Empty:
                    break
                try:
                    fn()
                except Exception:       # a command must not kill the daemon
                    traceback.print_exc()
            if self._stop.is_set():
                break
            try:
                progressed = self.pool.step()
            except Exception:
                # a dispatch failure poisons the shared pool — fail the
                # in-flight studies on the wire and stop (their periodic
                # snapshots resume them on the next daemon start)
                traceback.print_exc()
                self._fail_active("pool dispatch error:\n"
                                  + traceback.format_exc(limit=3))
                self._stop.set()
                progressed = False
            if progressed:
                self._snapshot_tick()
            self._finish_ready()
            if not progressed and self._cmds.empty():
                self._wake.wait(0.02)
                self._wake.clear()
        # graceful drain: every in-flight study flushes a snapshot so a
        # restarted daemon resumes it bit-identically
        for st in list(self._studies.values()):
            if st.checkpoint is not None:
                self._snapshot(st)
                st.checkpoint.manager.wait()

    # ------------------------------------------------------------ admission

    def pool_contract(self) -> dict:
        """The result-affecting contract + schedule shape, for ``hello``."""
        return {"tol": float(self.pool.tol), "wss": self.pool.wss,
                "shrink_every": self.pool.shrink_every,
                "shrink_quantum": self.pool.shrink_quantum,
                "shrink_caps": list(self.pool.shrink_caps or ()) or None,
                "shrink_on_seed": self.pool.shrink_on_seed,
                "chunk_iters": self.pool.chunk_iters,
                "lane_quantum": self.pool.lane_quantum,
                "max_width": self.pool.max_width,
                "max_resident": self.pool.cache.max_resident,
                "cache_bytes": self.pool.cache.cache_bytes,
                "plan_chunk_budget": self.plan_chunk_budget,
                "plan_bytes_budget": self.plan_bytes_budget}

    def _check_contract(self, plan) -> None:
        if plan.shrink_every == "auto":
            raise ValueError(
                "shrink_every='auto' resolves against the CLIENT's cost "
                "model; a served plan must pin the pool's value "
                f"(shrink_every={self.pool.shrink_every})")
        pool_vals = {"tol": float(self.pool.tol), "wss": self.pool.wss,
                     "shrink_every": self.pool.shrink_every,
                     "shrink_quantum": self.pool.shrink_quantum,
                     "shrink_caps": self.pool.shrink_caps,
                     "shrink_on_seed": self.pool.shrink_on_seed}
        plan_vals = {"tol": float(plan.tol), "wss": plan.wss,
                     "shrink_every": int(plan.shrink_every),
                     "shrink_quantum": int(plan.shrink_quantum),
                     "shrink_caps": tuple(int(c) for c in plan.shrink_caps)
                     if plan.shrink_caps else None,
                     "shrink_on_seed": bool(plan.shrink_on_seed)}
        if not pool_vals["shrink_every"] and not plan_vals["shrink_every"]:
            # shrink sub-knobs are inert when shrinking is off on both
            for k in ("shrink_quantum", "shrink_caps", "shrink_on_seed"):
                plan_vals[k] = pool_vals[k]
        bad = [f"{k}: plan {plan_vals[k]!r} != pool {pool_vals[k]!r}"
               for k in CONTRACT_FIELDS if plan_vals[k] != pool_vals[k]]
        if bad:
            raise ValueError(
                "plan/pool contract mismatch (these change the iterate "
                "sequence — a served run must be bit-identical to the "
                "client's own): " + "; ".join(bad))

    def _check_tenant_budget(self, pa, context: str) -> None:
        """Hold the daemon's per-plan budgets against the MAX-BOUND
        simulated schedule (``pa.sim["max"]``): worst-case lane-chunk
        and peak-resident-byte cost, known before any kernel
        materializes. Budget breaches become ``tenant-budget`` error
        findings and a structured :class:`PlanRejected`."""
        if not (self.plan_chunk_budget or self.plan_bytes_budget):
            return
        hi = (pa.sim or {}).get("max")
        if hi is None:
            # the simulator degraded (a sim-error warning is already on
            # the report) — a budget that cannot be checked cannot be
            # held, so the plan is refused
            pa.report.add(
                "tenant-budget", "<plan>", "schedule",
                "daemon enforces per-plan budgets but the schedule "
                "simulation produced no max bound", context=context)
        else:
            if self.plan_chunk_budget and \
                    hi["lane_chunks"] > self.plan_chunk_budget:
                pa.report.add(
                    "tenant-budget", "<plan>", "lane_chunks",
                    f"max-bound schedule costs {hi['lane_chunks']} "
                    f"lane-chunks, over the daemon's per-plan budget of "
                    f"{self.plan_chunk_budget}", context=context)
            if self.plan_bytes_budget and \
                    hi["peak_resident_bytes"] > self.plan_bytes_budget:
                pa.report.add(
                    "tenant-budget", "<plan>", "resident_bytes",
                    f"max-bound schedule co-holds "
                    f"{hi['peak_resident_bytes']} resident bytes, over "
                    f"the daemon's per-plan budget of "
                    f"{self.plan_bytes_budget}", context=context)
        bad = [f for f in pa.report.errors if f.rule == "tenant-budget"]
        if bad:
            raise plan_check.PlanRejected(
                "daemon per-plan budget exceeded:\n"
                + "\n".join(f.render() for f in bad), pa)

    def _checkpoint_for(self, tenant: str, plan_id: str, plan):
        if not self.checkpoint_root:
            return None
        mgr = CheckpointManager.namespaced(
            self.checkpoint_root, tenant, plan_id,
            max_to_keep=self.max_to_keep)
        return study_mod.StudyCheckpoint(
            manager=mgr, every=self.snapshot_every,
            meta={"study": f"{tenant}/{plan_id}", "tol": float(plan.tol),
                  "wss": plan.wss})

    def submit(self, tenant: str, plan_id: str, plan_dict, emit) -> None:
        """Admission gate + enrollment; SERVICE THREAD ONLY. Emits exactly
        one of: ``rejected`` (nothing entered the pool), or ``admitted``
        followed by the study's event stream."""
        ns = f"{tenant}/{plan_id}"
        try:
            if ns in self._studies:
                raise ValueError(f"study {ns!r} is already in flight")
            # parsed onto host tensors: admission puts nothing on the card
            plan = study_mod.plan_from_dict(plan_dict, device=self.device)
            plan = study_mod.resolve_source_backend(plan)
            self._check_contract(plan)
            # schedule-only knobs are the POOL's (bit-parity makes the
            # schedule shape free); the budget the analyzer audits is the
            # pool's real budget, not the client's wish
            plan = dataclasses.replace(
                plan, chunk_iters=self.pool.chunk_iters,
                lane_quantum=self.pool.lane_quantum,
                max_width=self.pool.max_width,
                max_resident=self.pool.cache.max_resident,
                cache_bytes=self.pool.cache.cache_bytes)
            ckpt = self._checkpoint_for(tenant, plan_id, plan)
            # the admission gate: invalid graphs, budget-infeasible
            # sources, colliding checkpoint ranges are refused before any
            # kernel materializes
            pa = plan_check.check_plan(plan, checkpoint=ckpt, context=ns)
            storms = [f for f in pa.report if f.rule == "recompile-storm"]
            if storms:
                # daemon policy: the warning becomes a refusal (the pool is
                # shared, a storm of launch shapes taxes every tenant)
                raise plan_check.PlanRejected(
                    "daemon policy rejects compile-storm plans:\n"
                    + "\n".join(f.render() for f in storms), pa)
            self._check_tenant_budget(pa, ns)
        except plan_check.PlanRejected as e:
            emit({"type": "rejected", "plan_id": plan_id, "error": str(e),
                  "findings": e.analysis.report.to_json()["findings"],
                  "analysis": e.analysis.to_json()})
            return
        except (ValueError, TypeError, KeyError) as e:
            emit({"type": "rejected", "plan_id": plan_id, "error": str(e),
                  "findings": []})
            return

        idents = {okey: source_identity(entry, plan.y_of(okey))
                  for okey, entry in plan.sources.items()}
        ns_plan, key_map, dedup_hits, new_keys = self._namespace(
            ns, study_mod.plan_on_device(plan), idents)
        specs = study_mod.plan_specs(ns_plan)
        step0, restored = study_mod.restore_study_lanes(ckpt)
        pre_done = study_mod.enroll_plan_lanes(
            self.pool, ns_plan, specs, restored, tenant=tenant)
        lane_ids = set(specs)
        st = _Study(
            tenant=tenant, plan_id=plan_id, ns=ns, plan=ns_plan,
            specs=specs, emit=emit, lane_ids=lane_ids,
            remaining=lane_ids - pre_done,
            source_keys=tuple(dict.fromkeys(key_map.values())),
            checkpoint=ckpt,
            step=max(step0, study_mod.STUDY_BASE),
            dedup_hits=dedup_hits, restored=frozenset(pre_done))
        self._studies[ns] = st
        emit({"type": "admitted", "plan_id": plan_id,
              "lanes": len(lane_ids), "restored": len(pre_done),
              "dedup_hits": dedup_hits,
              "sources_admitted": len(new_keys),
              "analysis": {"program_count": pa.program_count,
                           "max_width": pa.max_width}})
        for spec in ns_plan.lanes:       # restored-done results, in order
            if spec.id in pre_done:
                self._emit_result(st, spec.id, self.pool.results[spec.id])
        self._wake.set()

    def _namespace(self, ns: str, plan, idents: dict):
        """Rewrite a validated plan, on the device, for the shared pool:
        lane ids become ``(ns, orig)``, source keys become digests of the
        sources' content identities ``idents`` (deduped against every
        resident study), y becomes per-key."""
        key_map: dict = {}
        ys: dict = {}
        sources: dict = {}
        dedup_hits, new_keys = 0, []
        for okey, entry in plan.sources.items():
            y = plan.y_of(okey)
            ident = idents[okey]
            pkey = self._ident_to_key.get(ident) if ident is not None \
                else None
            if pkey is not None:
                if pkey not in key_map.values():
                    dedup_hits += 1
            else:
                digest = hashlib.sha1(repr(ident).encode()).hexdigest() \
                    if ident is not None else hashlib.sha1(
                        f"{ns}:{okey!r}".encode()).hexdigest()
                pkey = ("src", digest[:16])
                self.pool.add_source(pkey, entry, y)
                if ident is not None:
                    self._ident_to_key[ident] = pkey
                    self._key_ident[pkey] = ident
                new_keys.append(pkey)
            key_map[okey] = pkey
            sources[pkey] = self.pool.sources[pkey]
            ys[pkey] = self.pool.y_of(pkey)
        for pkey in dict.fromkeys(key_map.values()):
            self._key_refs[pkey] = self._key_refs.get(pkey, 0) + 1
        lanes = [dataclasses.replace(
            spec, id=(ns, spec.id),
            source=None if spec.result is not None
            else key_map[plan.source_key_of(spec)],
            dep=None if spec.dep is None else (ns, spec.dep),
            after=None if spec.after is None else (ns, spec.after))
            for spec in plan.lanes]
        evals = [study_mod.EvalSpec((ns, ev.lane), ev.test_idx)
                 for ev in plan.evals]
        ns_plan = dataclasses.replace(plan, sources=sources, y=ys,
                                      lanes=lanes, evals=evals)
        return ns_plan, key_map, dedup_hits, new_keys

    # ------------------------------------------------------------- events

    def _emit_result(self, st: _Study, lane_id, result) -> None:
        st.remaining.discard(lane_id)
        _, orig = lane_id
        st.emit({"type": "result", "plan_id": st.plan_id,
                 "lane": study_mod._to_wire(orig),
                 "result": study_mod.result_to_dict(result)})

    def _route_result(self, lane_id, result) -> None:
        """Pool ``on_result`` hook: fan a retirement out to its study."""
        st = self._studies.get(lane_id[0] if isinstance(lane_id, tuple)
                               else None)
        if st is not None and lane_id in st.lane_ids:
            self._emit_result(st, lane_id, result)

    def _finish_ready(self) -> None:
        for ns in list(self._studies):
            st = self._studies[ns]
            if st.remaining:
                continue
            results = {lid: self.pool.results[lid] for lid in st.lane_ids}
            try:
                evals = study_mod.run_plan_evals(
                    self.pool, st.plan, st.specs, results)
            except Exception as e:
                st.emit({"type": "error", "plan_id": st.plan_id,
                         "error": f"evaluation failed: {e}"})
                evals = {}
            if st.checkpoint is not None:
                # final flush: resubmitting this (tenant, plan_id) later
                # restores every lane pre-solved
                self._snapshot(st)
                st.checkpoint.manager.wait()
            tstats = self.pool.tenant_stats().get(st.tenant, {})
            st.emit({"type": "done", "plan_id": st.plan_id,
                     "evals": [[study_mod._to_wire(lid[1]),
                                [int(c), int(t)]]
                               for lid, (c, t) in evals.items()],
                     "restored": [study_mod._to_wire(lid[1])
                                  for lid in sorted_wire(st.restored)],
                     "study_source_stats": {
                         "dedup_hits": st.dedup_hits,
                         "sources_admitted": len(st.source_keys)
                         - st.dedup_hits},
                     "source_stats": dict(self.pool.cache.stats),
                     "tenant_stats": tstats})
            self._cleanup(st)

    def _cleanup(self, st: _Study) -> None:
        self.pool.remove_lanes(st.lane_ids)
        for pkey in st.source_keys:
            self._key_refs[pkey] -= 1
            if self._key_refs[pkey] <= 0:
                del self._key_refs[pkey]
                ident = self._key_ident.pop(pkey, None)
                if ident is not None:
                    self._ident_to_key.pop(ident, None)
                self.pool.remove_source(pkey)
        del self._studies[st.ns]

    def _fail_active(self, message: str) -> None:
        for st in list(self._studies.values()):
            st.emit({"type": "error", "plan_id": st.plan_id,
                     "error": message})

    # ----------------------------------------------------------- snapshots

    def _snapshot_tick(self) -> None:
        if self.pool.chunk_count % self.snapshot_every:
            return
        for st in self._studies.values():
            if st.checkpoint is not None and st.remaining:
                self._snapshot(st)

    def _snapshot(self, st: _Study) -> None:
        ids, tree = self.pool.snapshot_lanes(only=st.lane_ids)
        if not ids:
            return
        st.step += 1
        st.checkpoint.manager.save(
            st.step, tree,
            extra_meta={"phase": st.checkpoint.phase, "lane_ids": ids,
                        **st.checkpoint.meta},
            blocking=True, retain_class=st.checkpoint.retain_class)

    # -------------------------------------------------------------- status

    def status(self) -> dict:
        """SERVICE THREAD ONLY (route through ``enqueue``)."""
        return {"type": "status",
                "studies": [{"study": ns, "lanes": len(st.lane_ids),
                             "remaining": len(st.remaining)}
                            for ns, st in self._studies.items()],
                "tenants": {str(t): dict(rec) for t, rec in
                            self.pool.tenant_stats().items()},
                "occupancy": self.pool.occupancy,
                "source_stats": dict(self.pool.cache.stats),
                "resident_sources": len(self._key_refs)}


def sorted_wire(ids):
    """Deterministic ordering for mixed-type lane ids on the wire."""
    return sorted(ids, key=repr)


class StudyServer:
    """AF_UNIX front end: accept loop + one framing-only handler thread
    per connection. No torch work happens on these threads: every op is
    forwarded to the service thread via ``enqueue``, and every event the
    service emits for a connection goes through that connection's write
    lock (the service thread and the handler thread share the socket)."""

    def __init__(self, socket_path: str, service: StudyService):
        self.socket_path = socket_path
        self.service = service
        self._listener: socket.socket | None = None
        self._accepting = threading.Event()

    def serve_forever(self) -> None:
        """Bind, start the service thread, accept until ``shutdown``.
        Returns after the graceful drain completes."""
        if os.path.exists(self.socket_path):
            os.unlink(self.socket_path)        # stale socket from a kill
        self._listener = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        self._listener.bind(self.socket_path)
        self._listener.listen()
        # accept wakes every ACCEPT_POLL_S to see a stop: closing a
        # listening socket does not wake a blocked accept on every kernel
        self._listener.settimeout(ACCEPT_POLL_S)
        self.service.start()
        self._accepting.set()
        try:
            while self._accepting.is_set():
                try:
                    conn, _ = self._listener.accept()
                except TimeoutError:
                    continue
                except OSError:                # listener closed by shutdown
                    break
                conn.settimeout(None)
                threading.Thread(target=self._handle, args=(conn,),
                                 daemon=True).start()
        finally:
            self.service.request_stop()
            self.service.join()
            self._listener.close()
            if os.path.exists(self.socket_path):
                os.unlink(self.socket_path)

    def stop_accepting(self) -> None:
        self._accepting.clear()
        if self._listener is not None:
            try:
                self._listener.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            self._listener.close()

    @staticmethod
    def _make_emit(wfile, lock):
        """An emit closure that survives a vanished client: once a write
        fails, further events are dropped — the study itself keeps
        running (results land in the pool, snapshots flush), it just has
        no listener."""
        dead = [False]

        def emit(msg) -> None:
            if dead[0]:
                return
            try:
                protocol.send_msg(wfile, msg, lock)
            except (OSError, ValueError):
                dead[0] = True
        return emit

    def _handle(self, conn: socket.socket) -> None:
        rfile = conn.makefile("rb")
        wfile = conn.makefile("wb")
        lock = threading.Lock()
        emit = self._make_emit(wfile, lock)
        tenant = None
        try:
            while True:
                try:
                    msg = protocol.recv_msg(rfile)
                except ValueError as e:        # framing error: drop conn
                    emit({"type": "error", "error": str(e)})
                    return
                if msg is None:
                    return
                op = msg.get("op") if isinstance(msg, dict) else None
                if op == "hello":
                    tenant = str(msg.get("tenant", ""))
                    if not tenant:
                        emit({"type": "error",
                              "error": "hello needs a tenant name"})
                        continue
                    emit({"type": "hello",
                          "pool": self.service.pool_contract()})
                elif op == "submit":
                    if tenant is None:
                        emit({"type": "error",
                              "error": "submit before hello"})
                        continue
                    plan_id = str(msg.get("plan_id", ""))
                    if not plan_id:
                        emit({"type": "error",
                              "error": "submit needs a plan_id"})
                        continue
                    plan_dict = msg.get("plan")
                    self.service.enqueue(
                        lambda t=tenant, p=plan_id, d=plan_dict:
                        self.service.submit(t, p, d, emit))
                elif op == "status":
                    self.service.enqueue(
                        lambda: emit(self.service.status()))
                elif op == "shutdown":
                    self.stop_accepting()
                    self.service.request_stop()
                    self.service.join()
                    emit({"type": "bye"})
                    return
                else:
                    emit({"type": "error",
                          "error": f"unknown op {op!r}"})
        finally:
            try:
                rfile.close()
                wfile.close()
            except OSError:
                pass
            conn.close()
