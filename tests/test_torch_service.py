"""The port's study daemon (``repro_torch.service``) on the CPU.

As the reference's own service tests do, most tests drive
``StudyService`` on the calling thread (no service thread: the test is the
service thread), so admission order and interleaving are deterministic;
the socket tests run the real ``StudyServer``. Within the port: a served
plan is bitwise its in-process ``run_plan``, two tenants' studies on one
kernel read one resident source, admission refuses before anything
materializes, and a killed daemon resumes under another width. Across the
packages: the reference's client against the port's server, and the
port's client against the reference's server, get lanes bitwise the
reference's in-process ``run_plan`` (cold lanes over one dense K: no seed
arithmetic of either package enters them)."""
import dataclasses
import json
import os
import threading
import time
import uuid

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import study as rstudy
from repro.core.cv import _fold_masks, _transition_idx
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.service import StudyClient as RefClient
from repro.service import StudyServer as RefServer
from repro.service import StudyService as RefService
from repro.svm import DenseKernel as RDense
from repro.svm import kernel_matrix as ref_kernel_matrix

from repro_torch.core import study as pstudy
from repro_torch.service import (PlanRejectedByServer, StudyClient,
                                 StudyServer, StudyService)
from repro_torch.svm import DenseKernel, KernelSpec


@pytest.fixture(scope="module")
def data():
    ds = make_dataset("heart", n_override=120)
    chunks = kfold_chunks(ds.n, 4, seed=0)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], dtype=torch.float64)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64)
    K = np.array(ref_kernel_matrix(jnp.asarray(ds.X[:n]),
                                   jnp.asarray(ds.X[:n]), gamma=ds.gamma))
    return ds, X, y, chunks, torch.as_tensor(_fold_masks(chunks)), K


def _chain_plan(sources, y, masks, chunks, C, folds=3, **knobs):
    """Per-source SIR fold chains with tuple lane ids and per-fold evals."""
    plan = pstudy.Plan(sources=dict(sources), y=y, chunk_iters=64,
                       lane_quantum=2, device="cpu", **knobs)
    n = y.shape[0]
    for key in sources:
        plan.lane((key, 0), source=key, train_mask=masks[0], C=C,
                  alpha0=torch.zeros(n, dtype=torch.float64), f0=-y)
        for h in range(1, folds):
            S, R, T = (torch.as_tensor(np.array(a)) for a in
                       _transition_idx(chunks, h - 1, h))
            plan.lane((key, h), source=key, train_mask=masks[h], C=C,
                      dep=(key, h - 1), transform="fold",
                      params=dict(method="sir", S_idx=S, R_idx=R, T_idx=T))
        for h in range(folds):
            plan.evaluate((key, h), chunks[h])
    return plan


def _wire(plan) -> dict:
    return json.loads(json.dumps(pstudy.plan_to_dict(plan)))


def _drain(service) -> None:
    while service._studies:
        service.pool.step()
        service._snapshot_tick()
        service._finish_ready()


def _events_of(emitted, kind):
    return [m for m in emitted if m["type"] == kind]


def _served(emitted):
    return {pstudy._from_wire(m["lane"]): pstudy.result_from_dict(m["result"])
            for m in _events_of(emitted, "result")}


def _same_bits(want, got) -> None:
    assert set(want) == set(got)
    for lid, w in want.items():
        g = got[lid]
        np.testing.assert_array_equal(np.asarray(w.alpha), np.asarray(g.alpha))
        np.testing.assert_array_equal(np.asarray(w.f), np.asarray(g.f))
        assert int(w.n_iter) == int(g.n_iter)
        assert bool(w.converged) == bool(g.converged)


def _evals(done):
    return {pstudy._freeze(lid): tuple(ct) for lid, ct in done["evals"]}


def test_two_tenants_one_kernel_bitwise(data):
    """Two tenants' studies over overlapping gammas, in flight at once:
    each bitwise its solo ``run_plan``, the shared kernel admitted once
    (one dedup hit), fewer materializations than the solo runs."""
    ds, X, y, chunks, masks, _ = data
    spec = {s: KernelSpec(X=X, gamma=s * ds.gamma, n=y.shape[0])
            for s in (0.5, 1.0, 2.0)}
    plan_a = _chain_plan({0.5: spec[0.5], 1.0: spec[1.0]}, y, masks, chunks,
                         ds.C, max_resident=2)
    plan_b = _chain_plan({1.0: spec[1.0], 2.0: spec[2.0]}, y, masks, chunks,
                         ds.C, max_resident=2)
    solo_a, solo_b = pstudy.run_plan(plan_a), pstudy.run_plan(plan_b)
    solo_mats = (solo_a.source_stats["materializations"]
                 + solo_b.source_stats["materializations"])
    service = StudyService(chunk_iters=64, lane_quantum=2, max_width=0,
                           max_resident=3, device="cpu")
    ev_a, ev_b = [], []
    service.submit("alice", "study", _wire(plan_a), ev_a.append)
    service.submit("bob", "study", _wire(plan_b), ev_b.append)
    assert service.pool.cache.stats["materializations"] == 0
    _drain(service)
    (adm_a,), (adm_b,) = _events_of(ev_a, "admitted"), \
        _events_of(ev_b, "admitted")
    assert (adm_a["dedup_hits"], adm_a["sources_admitted"]) == (0, 2)
    assert (adm_b["dedup_hits"], adm_b["sources_admitted"]) == (1, 1)
    _same_bits(solo_a.results, _served(ev_a))
    _same_bits(solo_b.results, _served(ev_b))
    (done_a,), (done_b,) = _events_of(ev_a, "done"), _events_of(ev_b, "done")
    assert _evals(done_a) == solo_a.evals and _evals(done_b) == solo_b.evals
    assert service.pool.cache.stats["materializations"] == 3 < solo_mats
    assert done_a["tenant_stats"]["served"] > 0
    assert done_b["tenant_stats"]["served"] > 0
    assert not service.pool.sources and not service.pool._lanes
    assert service._key_refs == {} and service._ident_to_key == {}


def test_fair_share_interleaves_tenants_under_width_cap(data):
    ds, X, y, chunks, masks, K = data
    plan = _chain_plan({"k": DenseKernel(torch.from_numpy(K))}, y, masks,
                       chunks, ds.C)
    service = StudyService(chunk_iters=64, lane_quantum=2, max_width=1,
                           device="cpu")
    ev_a, ev_b = [], []
    service.submit("alice", "s", _wire(plan), ev_a.append)
    service.submit("bob", "s", _wire(plan), ev_b.append)
    _drain(service)
    served = {t: r["served"] for t, r in service.pool.tenant_stats().items()}
    assert served["alice"] > 0 and abs(served["alice"] - served["bob"]) <= 1
    _same_bits(pstudy.run_plan(plan).results, _served(ev_a))


def _refused(service, plan, tenant="alice", plan_id="p"):
    events = []
    service.submit(tenant, plan_id, _wire(plan), events.append)
    (rej,) = events
    assert rej["type"] == "rejected"
    assert not service._studies and not service.pool.sources
    assert service.pool.cache.stats["materializations"] == 0
    return rej


def test_admission_refuses_before_anything_materializes(data):
    """Invalid graphs, a source over the pool's budget, a schedule that
    co-holds more than the budget, a storm of launch shapes, a contract
    mismatch: each refused with its findings (named by tenant/plan) and
    the analysis attached, the pool untouched."""
    ds, X, y, chunks, masks, K = data
    n = y.shape[0]
    dense = _chain_plan({"k": DenseKernel(torch.from_numpy(K))}, y, masks,
                        chunks, ds.C)
    dup = _chain_plan({"k": DenseKernel(torch.from_numpy(K))}, y, masks,
                      chunks, ds.C)
    dup.lane(("k", 0), source="k", train_mask=masks[0], C=ds.C,
             alpha0=torch.zeros(n, dtype=torch.float64), f0=-y)
    rej = _refused(StudyService(chunk_iters=64, lane_quantum=2,
                                device="cpu"), dup)
    assert "duplicate" in rej["error"]
    assert [f["rule"] for f in rej["findings"]] == ["invalid-plan"]

    one = _chain_plan({"k": KernelSpec(X=X, gamma=ds.gamma, n=n)}, y, masks,
                      chunks, ds.C)
    rej = _refused(StudyService(chunk_iters=64, lane_quantum=2,
                                cache_bytes=1000, device="cpu"), one,
                   plan_id="big")
    hits = [f for f in rej["findings"] if f["rule"] == "cache-infeasible"]
    assert hits and all(f["context"] == "alice/big" for f in hits)
    assert rej["analysis"]["per_source"]

    # each managed K fits on top of the pinned one, and the budget admits
    # both managed Ks at once (the budget rule counts managed bytes), but
    # with the pinned K the schedule co-holds more than the budget
    three = _chain_plan({"pin": DenseKernel(torch.from_numpy(K)), **{
        g: KernelSpec(X=X, gamma=g * ds.gamma, n=n) for g in (0.5, 2.0)}},
        y, masks, chunks, ds.C, folds=1)
    budget = 2 * n * n * 8 + n * n * 2
    rej = _refused(StudyService(chunk_iters=64, lane_quantum=2,
                                cache_bytes=budget, device="cpu"), three)
    rules = {f["rule"]: f["severity"] for f in rej["findings"]
             if f["severity"] == "error"}
    assert rules == {"cache-infeasible-time": "error"}
    assert rej["analysis"]["sim"]["min"]["peak_resident_bytes"] == \
        3 * n * n * 8 > budget

    storm = pstudy.Plan(sources={"k": DenseKernel(torch.from_numpy(K))},
                        y=y, chunk_iters=64, device="cpu")
    for i in range(9):
        storm.lane(i, train_mask=masks[i % 3], C=ds.C,
                   alpha0=torch.zeros(n, dtype=torch.float64), f0=-y)
        storm.evaluate(i, chunks[i % 3])
    rej = _refused(StudyService(chunk_iters=64, lane_quantum=1,
                                max_width=0, device="cpu"), storm)
    assert "compile-storm" in rej["error"]
    assert any(f["rule"] == "recompile-storm" for f in rej["findings"])

    service = StudyService(chunk_iters=64, lane_quantum=2, device="cpu")
    rej = _refused(service, dataclasses.replace(dense, tol=1e-5))
    assert "tol" in rej["error"] and rej["findings"] == []
    ok, again = [], []
    service.submit("alice", "t", _wire(dense), ok.append)
    service.submit("alice", "t", _wire(dense), again.append)
    assert _events_of(ok, "admitted")
    (rej,) = again
    assert rej["type"] == "rejected" and "in flight" in rej["error"]
    _drain(service)


def test_killed_daemon_resumes_under_another_width(tmp_path, data):
    """Snapshots mid-flight, the service abandoned without a drain; a new
    service with another width takes the same (tenant, plan_id): retired
    lanes enter solved, live ones resume, every lane bitwise the solo
    run."""
    ds, X, y, chunks, masks, K = data
    plan = _chain_plan({g: DenseKernel(torch.from_numpy(np.array(
        ref_kernel_matrix(jnp.asarray(X.numpy()), jnp.asarray(X.numpy()),
                          gamma=g * ds.gamma)))) for g in (0.5, 2.0)},
        y, masks, chunks, ds.C)
    solo = pstudy.run_plan(plan)
    root = str(tmp_path / "ckpt")
    first = StudyService(chunk_iters=64, lane_quantum=2, max_width=0,
                         checkpoint_root=root, device="cpu")
    ev1 = []
    first.submit("alice", "grid", _wire(plan), ev1.append)
    while not _events_of(ev1, "result"):      # until a lane retires
        first.pool.step()
        first._snapshot_tick()
    assert first._studies
    retired = {pstudy._freeze(m["lane"]) for m in _events_of(ev1, "result")}
    again = StudyService(chunk_iters=64, lane_quantum=2, max_width=1,
                         checkpoint_root=root, device="cpu")
    ev2 = []
    again.submit("alice", "grid", _wire(plan), ev2.append)
    (adm,) = _events_of(ev2, "admitted")
    assert adm["restored"] == len(retired) > 0
    _drain(again)
    _same_bits(solo.results, _served(ev2))
    (done,) = _events_of(ev2, "done")
    assert _evals(done) == solo.evals
    assert {pstudy._freeze(lid) for lid in done["restored"]} == retired


def _serve(server):
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    for _ in range(200):
        if os.path.exists(server.socket_path):
            break
        time.sleep(0.05)
    return thread


def _socket():
    return f"/tmp/study-{uuid.uuid4().hex[:8]}.sock"   # AF_UNIX path cap


def _cold_plan(mod, source, y, masks, chunks, C):
    """Cold lanes of three Cs, one held behind another, with evals."""
    plan = mod.Plan(sources={"k": source}, y=y, chunk_iters=64,
                    lane_quantum=2)
    for h in range(3):
        plan.lane(h, train_mask=masks[h], C=C * (1 + h),
                  alpha0=np.zeros(y.shape[0]), f0=-y,
                  after=0 if h == 2 else None)
        plan.evaluate(h, chunks[h])
    return plan


@pytest.mark.parametrize("server_side", ["port", "reference"])
def test_socket_daemon_serves_the_other_packages_client(data, server_side):
    """The real daemon over AF_UNIX: the reference's client on the port's
    server, or the port's client on the reference's server; lanes bitwise
    the reference's in-process ``run_plan``, counts equal; status,
    refusal over the wire, streamed results, drain."""
    ds, X, y, chunks, masks, K = data
    yn, mn = y.numpy(), masks.numpy()
    ref_plan = _cold_plan(rstudy, RDense(jnp.asarray(K)), yn, mn, chunks,
                          ds.C)
    port_plan = _cold_plan(pstudy, DenseKernel(torch.from_numpy(K)), yn, mn,
                           chunks, ds.C)
    solo = rstudy.run_plan(ref_plan, analysis="off")
    sock = _socket()
    if server_side == "port":
        server = StudyServer(sock, StudyService(
            chunk_iters=64, lane_quantum=2, max_width=0, device="cpu"))
        client, plan, rejected = None, ref_plan, ValueError
    else:
        server = RefServer(sock, RefService(chunk_iters=64, lane_quantum=2,
                                            max_width=0))
        client, plan, rejected = None, port_plan, PlanRejectedByServer
    thread = _serve(server)
    client = (RefClient if server_side == "port" else StudyClient)(
        sock, "alice")
    try:
        with client as cli:
            assert cli.pool_contract["tol"] == 1e-3
            streamed = []
            served = cli.submit("p", plan,
                                on_result=lambda lid, r: streamed.append(lid))
            _same_bits(solo.results, served.results)
            assert served.evals == solo.evals
            assert set(streamed) == set(solo.results)
            assert served.tenant_stats["served"] > 0
            with pytest.raises(rejected, match="tol"):
                cli.submit("q", dataclasses.replace(plan, tol=1e-5))
            status = cli.status()
            assert status["studies"] == [] and "alice" in status["tenants"]
            cli.shutdown()
        thread.join(timeout=30)
        assert not thread.is_alive()
    finally:
        server.stop_accepting()
        if os.path.exists(sock):
            os.unlink(sock)


def test_port_client_and_server_end_to_end(data):
    """The port's client on the port's daemon, a SIR chain over a spec:
    bitwise the in-process run, the refusal's analysis on the wire."""
    ds, X, y, chunks, masks, _ = data
    plan = _chain_plan({"g": KernelSpec(X=X, gamma=ds.gamma, n=y.shape[0])},
                       y, masks, chunks, ds.C)
    solo = pstudy.run_plan(plan)
    sock = _socket()
    server = StudyServer(sock, StudyService(
        chunk_iters=64, lane_quantum=2, max_width=0, device="cpu",
        cache_bytes=y.shape[0] ** 2 * 8))
    thread = _serve(server)
    try:
        with StudyClient(sock, "bob") as cli:
            served = cli.submit("p", plan)
            _same_bits(solo.results, served.results)
            assert served.evals == solo.evals
            assert served.sources_admitted == 1 and served.dedup_hits == 0
            too_big = _chain_plan({"g": KernelSpec(X=X, gamma=ds.gamma)},
                                  y, masks, chunks, ds.C)
            too_big.sources["g"] = KernelSpec(X=torch.cat([X, X]),
                                              gamma=ds.gamma)
            with pytest.raises(PlanRejectedByServer) as err:
                cli.submit("q", too_big)
            assert "cache-infeasible" in {f["rule"]
                                          for f in err.value.findings}
            assert err.value.analysis["peak_managed_bytes"] == \
                4 * y.shape[0] ** 2 * 8
            cli.shutdown()
        thread.join(timeout=30)
    finally:
        server.stop_accepting()
        if os.path.exists(sock):
            os.unlink(sock)
