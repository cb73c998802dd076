"""The port's lane pool (``svm/scheduler.py``), its source cache and cost
model, and ``core/study.py::run_plan`` against the reference's, on the CPU.

The pool's pure helpers must return what the reference's return over a
table of inputs. On a shared dense K every lane must end bitwise where the
reference's ``run_plan`` and the port's own one-lane ``solve`` end (alpha,
f, n_iter), at every width cap, and the port's schedule (its trace of
admissions, packs, dispatches and retirements) must be the reference's. A
``PallasRBF`` pool must give bitwise the same lanes at every width.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.study import Plan as RefPlan
from repro.core.study import run_plan as ref_run_plan
from repro.data.svm_suite import make_dataset
from repro.svm import cost_model as ref_cost_model
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm import scheduler as ref_sched
from repro.svm import sources as ref_sources
from repro.svm.scheduler import LanePool as RefPool
from repro_torch.convert import lane_from_reference, source_from_reference
from repro_torch.core.study import Plan, run_plan
from repro_torch.svm import cost_model, scheduler, sources
from repro_torch.svm.engine import solve
from repro_torch.svm.scheduler import LanePool
from repro_torch.svm.sources import KernelSpec

# ------------------------------------------------------------ pure helpers


def test_bucket_and_possible_widths_match_reference():
    for w, q in itertools.product(range(0, 21), (1, 2, 3, 4, 8)):
        assert scheduler.bucket_width(w, q) == ref_sched.bucket_width(w, q)
    for peak, q, cap in itertools.product(range(0, 13), (1, 2, 4),
                                          (0, 1, 2, 3, 5, 8)):
        assert scheduler.possible_widths(peak, q, cap) == \
            ref_sched.possible_widths(peak, q, cap)


#: synthetic lanes (id, source, served, tenant) for the selection helpers
_LANES = [(0, "a", 3, None), (1, "b", 0, None), (2, "a", 1, None),
          (3, "c", 0, None), (4, "b", 2, None), (5, "c", 1, None),
          (6, "a", 0, None)]
_TENANT_LANES = [(i, s, srv, "t1" if i % 3 else "t2")
                 for i, s, srv, _ in _LANES]


@pytest.mark.parametrize("sticky", [None, "a", "b", "c"])
@pytest.mark.parametrize("resident", [set(), {"a"}, {"b", "c"}])
@pytest.mark.parametrize("lanes", [_LANES, _TENANT_LANES])
def test_selection_helpers_match_reference(sticky, resident, lanes):
    kw = dict(sticky=sticky, resident=lambda s: s in resident,
              served=lambda ln: ln[2], source=lambda ln: ln[1])
    assert scheduler.order_capped(lanes, **kw) == \
        ref_sched.order_capped(lanes, **kw)
    for max_width in (1, 2, 3, 5, 10):
        for tenant_served in ({}, {"t1": 4, "t2": 1}):
            sel = dict(kw, max_width=max_width, tenant=lambda ln: ln[3],
                       tenant_served=tenant_served)
            assert scheduler.select_capped(lanes, **sel) == \
                ref_sched.select_capped(lanes, **sel)


@pytest.mark.parametrize("max_resident,cache_bytes",
                         [(0, 0), (1, 0), (2, 0), (0, 250), (2, 120)])
@pytest.mark.parametrize("sticky", [None, "k2", "k4"])
def test_budget_helpers_match_reference(max_resident, cache_bytes, sticky):
    nbytes = {"k0": 100, "k1": 50, "k2": 100, "k3": 10, "k4": 200}
    pinned = {"k1"}
    resident = {"k3", "k4"}
    srcs = ["k0", "k2", "k1", "k3", "k4", "k0"]

    def fits(c, b):
        return sources.budget_fits(c, b, max_resident=max_resident,
                                   cache_bytes=cache_bytes)

    for c, b in itertools.product(range(4), (0, 100, 250, 400)):
        assert fits(c, b) == ref_sources.budget_fits(
            c, b, max_resident=max_resident, cache_bytes=cache_bytes)
    kw = dict(budgeted=bool(max_resident or cache_bytes),
              pinned=lambda s: s in pinned, resident=lambda s: s in resident,
              sticky=sticky, nbytes=nbytes.__getitem__, fits=fits)
    assert scheduler.budget_sources(srcs, **kw) == \
        ref_sched.budget_sources(srcs, **kw)
    dist = {"k0": 2, "k2": 1, "k3": 1, "k4": 0}
    for order in itertools.permutations(["k0", "k2", "k3", "k4"]):
        assert sources.pick_victim(order, sticky=sticky,
                                   distance=dist.__getitem__) == \
            ref_sources.pick_victim(order, sticky=sticky,
                                    distance=dist.__getitem__)


@pytest.mark.parametrize("kinds", [("dense",), ("pallas_rbf",),
                                   ("dense", "pallas_rbf")])
def test_cost_model_matches_reference(kinds):
    """The committed model's cpu entry and synthetic ones give the
    reference's verdicts; a device type a model lacks falls back to 0
    (unbounded) as the reference's accelerator backends do."""
    assert cost_model.pick_max_width("cpu", kinds) == \
        ref_cost_model.pick_max_width("cpu", kinds) == 1
    assert cost_model.pick_max_width("cuda", kinds,
                                     model={"entries": {}}) == 0 == \
        ref_cost_model.pick_max_width("tpu", kinds)
    for model in ({"entries": {"cpu": {"dense": {"max_width": 4},
                                       "pallas_rbf": {"max_width": 0}}}},
                  {"entries": {"cpu": {"dense": {"max_width": 0}}}},
                  {"entries": {}}, None):
        assert cost_model.pick_max_width("cpu", kinds, model=model) == \
            ref_cost_model.pick_max_width("cpu", kinds, model=model)
    assert cost_model.source_kind(KernelSpec(torch.zeros(2, 2),
                                             kind="pallas_rbf")) \
        == "pallas_rbf"


# -------------------------------------------------------- the pool on a K


def _problem(n=200):
    ds = make_dataset("adult", n_override=n)
    X = jnp.asarray(ds.X)
    K = np.array(ref_kernel_matrix(X, X, gamma=ds.gamma))
    y = ds.y.astype(np.float64)
    masks = np.ones((5, n), bool)
    for h in range(5):
        masks[h, h * (n // 5):(h + 1) * (n // 5)] = False
    Cs = [ds.C, ds.C, 4.0 * ds.C, 0.5 * ds.C, ds.C]
    return ds, K, y, masks, Cs


def _ref_plan(K, y, masks, Cs, max_width, **kw):
    from repro.svm import DenseKernel as RefDense
    plan = RefPlan(sources={"K": RefDense(jnp.asarray(K))},
                   y=jnp.asarray(y), chunk_iters=96, max_width=max_width,
                   **kw)
    n = y.shape[0]
    for h in range(masks.shape[0]):
        plan.lane(h, train_mask=jnp.asarray(masks[h]), C=Cs[h],
                  alpha0=jnp.zeros(n), f0=-jnp.asarray(y), max_iter=10**6)
        plan.evaluate(h, np.flatnonzero(~masks[h]))
    return plan


@pytest.fixture(scope="module")
def problem():
    return _problem()


@pytest.mark.parametrize("max_width", [1, 2, 4, 8])
def test_run_plan_on_shared_K_bitwise(problem, max_width):
    """Per lane: alpha, f and n_iter bitwise the reference's run_plan and
    the port's one-lane solve; the held-out counts equal."""
    ds, K, y, masks, Cs = problem
    rplan = _ref_plan(K, y, masks, Cs, max_width)
    want = ref_run_plan(rplan, analysis="off")
    plan = Plan(sources={"K": source_from_reference(K=K, device="cpu")},
                y=torch.from_numpy(y), chunk_iters=96, max_width=max_width,
                lanes=[lane_from_reference(s, device="cpu")
                       for s in rplan.lanes],
                evals=list(rplan.evals), device="cpu")
    got = run_plan(plan)
    src = plan.sources["K"]
    yt = torch.from_numpy(y)
    for h in range(5):
        g, w = got.results[h], want.results[h]
        one = solve(src, yt, torch.from_numpy(masks[h]), Cs[h],
                    torch.zeros_like(yt), -yt, chunk_iters=96)
        for r in (w, one):
            np.testing.assert_array_equal(g.alpha.numpy(),
                                          np.asarray(r.alpha))
            np.testing.assert_array_equal(g.f.numpy(), np.asarray(r.f))
            assert int(g.n_iter) == int(r.n_iter)
        assert bool(g.converged)
        assert got.evals[h] == want.evals[h]
        assert got.stats[h].n_iter == want.stats[h].n_iter
    assert got.occupancy == want.occupancy


def test_pool_schedule_trace_matches_reference(problem):
    """The schedule itself — admissions, packs, dispatches (chunk, source,
    width, lanes), retirements with their n_iter, resident bytes — is the
    reference's, event for event, at a width cap of 2 with an ``after``
    edge holding one lane."""
    ds, K, y, masks, Cs = problem
    n = y.shape[0]
    from repro.svm import DenseKernel as RefDense
    from repro_torch.svm import DenseKernel

    def drive(pool, zeros, f0, mask_of):
        for h in range(4):
            pool.add(h, mask_of(h), Cs[h], zeros, f0, max_iter=10**6,
                     after=0 if h == 3 else None)
        pool.run()

    ref_events, port_events = [], []
    rpool = RefPool({"K": RefDense(jnp.asarray(K))}, jnp.asarray(y),
                    chunk_iters=64, max_width=2,
                    on_trace=ref_events.append)
    drive(rpool, jnp.zeros(n), -jnp.asarray(y),
          lambda h: jnp.asarray(masks[h]))
    yt = torch.from_numpy(y)
    ppool = LanePool({"K": DenseKernel(torch.from_numpy(K))}, yt,
                     chunk_iters=64, max_width=2,
                     on_trace=port_events.append)
    drive(ppool, torch.zeros(n, dtype=torch.float64), -yt,
          lambda h: torch.from_numpy(masks[h]))
    assert port_events == ref_events
    assert ppool.occupancy == rpool.occupancy


def test_pallas_pool_bitwise_across_widths():
    """PallasRBF lanes through the pool: bitwise the same at widths 1, 2,
    4 and 8 (capped runs of 300 iterations, chunks of 64)."""
    ds = make_dataset("heart", n_override=120)
    n = 120
    X = torch.from_numpy(ds.X.astype(np.float64))
    yt = torch.from_numpy(ds.y.astype(np.float64))
    out = {}
    for max_width in (1, 2, 4, 8):
        plan = Plan(sources={"X": KernelSpec(X, ds.gamma, kind="rbf")},
                    y=yt, wss="1", chunk_iters=64, max_width=max_width,
                    source_backend="pallas_rbf", device="cpu")
        for h in range(5):
            mask = torch.ones(n, dtype=torch.bool)
            mask[h * 24:(h + 1) * 24] = False
            plan.lane(h, train_mask=mask, C=ds.C,
                      alpha0=torch.zeros(n, dtype=torch.float64), f0=-yt,
                      max_iter=300)
        res = run_plan(plan)
        assert res.source_stats["materializations"] == 1
        out[max_width] = res.results
    for max_width in (2, 4, 8):
        for h in range(5):
            a, b = out[1][h], out[max_width][h]
            assert int(a.n_iter) == int(b.n_iter) == 300
            assert torch.equal(a.alpha, b.alpha) and torch.equal(a.f, b.f)


def test_source_cache_budget_evicts_and_rematerializes_bitwise(problem):
    """Two declared kernels under max_resident=1: the cache evicts by
    schedule distance and re-materializes the identical K, so every lane
    ends bitwise as in the unbudgeted pool."""
    ds, K, y, masks, Cs = problem
    X = torch.from_numpy(make_dataset("adult", n_override=200).X)
    yt = torch.from_numpy(y)
    results = {}
    for budget in (0, 1):
        pool = LanePool({g: KernelSpec(X, gamma=g) for g in (0.05, 0.2)},
                        yt, chunk_iters=64, max_width=1,
                        max_resident=budget)
        for h in range(4):
            pool.add(h, torch.from_numpy(masks[h]), ds.C,
                     torch.zeros(200, dtype=torch.float64), -yt,
                     source=0.05 if h % 2 else 0.2)
        results[budget] = pool.run()
        assert pool.cache.peak_resident == (2 if budget == 0 else 1)
        if budget:
            assert pool.cache.evictions >= 1
    for h in range(4):
        assert torch.equal(results[0][h].alpha, results[1][h].alpha)
        assert int(results[0][h].n_iter) == int(results[1][h].n_iter)


def test_run_plan_validates_by_name():
    yt = torch.ones(4, dtype=torch.float64)
    src = source_from_reference(K=np.eye(4), device="cpu")
    mask = torch.ones(4, dtype=torch.bool)
    z = torch.zeros(4, dtype=torch.float64)

    def plan(**lane):
        p = Plan(sources={"K": src}, y=yt, device="cpu")
        p.lane("a", train_mask=mask, C=1.0, alpha0=z, f0=-yt)
        p.lane("b", train_mask=mask, C=1.0, **lane)
        return p

    with pytest.raises(ValueError, match="lane 'b': unknown transform "
                                         "'nope'"):
        run_plan(plan(dep="a", transform="nope"))
    with pytest.raises(ValueError, match="undeclared lane 'zz'"):
        run_plan(plan(alpha0=z, f0=-yt, after="zz"))
    with pytest.raises(ValueError, match="unknown source key"):
        run_plan(plan(alpha0=z, f0=-yt, source="nope"))
    with pytest.raises(ValueError, match="duplicate lane id"):
        p = plan(alpha0=z, f0=-yt)
        p.lane("a", train_mask=mask, C=1.0, alpha0=z, f0=-yt)
        run_plan(p)
    with pytest.raises(ValueError, match="cycle"):
        p = Plan(sources={"K": src}, y=yt, device="cpu")
        p.lane("a", train_mask=mask, C=1.0, alpha0=z, f0=-yt, after="b")
        p.lane("b", train_mask=mask, C=1.0, alpha0=z, f0=-yt, after="a")
        run_plan(p)
    with pytest.raises(ValueError, match="requires WSS-1"):
        run_plan(Plan(sources={"K": src}, y=yt, source_backend="pallas_rbf",
                      device="cpu"))
