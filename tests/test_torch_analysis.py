"""The port's plan analyzer against the reference's, on equal plans at the
``"cpu"`` cost-model key: the same findings (rule, symbol, severity), the
same program count and launch-shape tuples, the same min- and max-bound
simulator summaries; and the port's simulator replays the port's live
pool event for event under the exact oracle."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.analysis import plan_check as ref_check
from repro.analysis import plan_sim as ref_sim
from repro.core import study as rstudy
from repro.core.grid import grid_plans as ref_grid_plans
from repro.data.svm_suite import make_dataset
from repro.svm import DenseKernel as RDense
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm.sources import KernelSpec as RSpec

from repro_torch.analysis import plan_check, plan_sim
from repro_torch.core import study as pstudy
from repro_torch.core.grid import grid_plans
from repro_torch.svm import DenseKernel, KernelSpec


@pytest.fixture(scope="module")
def ds():
    return make_dataset("adult", n_override=120)


def _grid(ds, **kw):
    args = (ds, [0.5, 1.0, 2.0], [ds.gamma, 2 * ds.gamma])
    return ref_grid_plans(*args, **kw)[0], \
        grid_plans(*args, device="cpu", **kw)[0]


def _custom(ds, case):
    """A plan of each finding's shape, built alike in both packages."""
    n = 120
    X = np.asarray(ds.X[:n])
    y = np.asarray(ds.y[:n], np.float64)
    K = np.array(ref_kernel_matrix(jnp.asarray(X), jnp.asarray(X),
                                   gamma=ds.gamma))
    masks = [np.arange(n) % 4 != h for h in range(4)]

    def build(mod, spec, dense, arr):
        if case == "pinned_and_managed":
            sources = {"pin": dense(K), "g1": spec(X=arr(X), gamma=0.5,
                                                    n=n),
                       "g2": spec(X=arr(X), gamma=2.0, n=n)}
            knobs = dict(cache_bytes=n * n * 8 * 9 // 4)
        elif case == "storm":
            sources, knobs = {"k": dense(K)}, dict(lane_quantum=1,
                                                   max_width=0)
        else:
            sources, knobs = {"g": spec(X=arr(X), gamma=ds.gamma, n=n)}, {}
        if case == "over_budget":
            knobs = dict(cache_bytes=1000)
        if case == "thrash":
            sources = {g: spec(X=arr(X), gamma=g, n=n) for g in (0.5, 1.0,
                                                                 2.0)}
            knobs = dict(max_resident=1, max_width=1)
        if case == "shrink":
            knobs = dict(shrink_every=64, shrink_quantum=32)
        kwargs = dict(device="cpu") if mod is pstudy else {}
        plan = mod.Plan(sources=sources, y=arr(y), chunk_iters=64, **knobs,
                        **kwargs)
        lanes = 9 if case == "storm" else 3
        keys = list(sources)
        for j, key in enumerate(keys):
            for i in range(lanes):
                common = dict(source=key, train_mask=arr(masks[i % 4]),
                              C=ds.C * (1 + i))
                if case == "thrash" and i:
                    # seeded from another source's lane: each admission
                    # resolves its own kernel, evicting the serving one
                    plan.lane((key, i), dep=(keys[(j + 1) % 3], i - 1),
                              transform="scale_C", params=dict(
                                  C_old=ds.C * i,
                                  train_mask=arr(masks[i % 4])), **common)
                else:
                    plan.lane((key, i), alpha0=arr(np.zeros(n)), f0=arr(-y),
                              after=(key, 0) if i == 2 else None, **common)
                if case != "dead" or i != 1:
                    plan.evaluate((key, i), np.flatnonzero(~masks[i % 4]))
        if case == "cycle":
            plan.lanes[0].after = plan.lanes[2].id
        return plan

    return build(rstudy, RSpec, lambda K: RDense(jnp.asarray(K)),
                 jnp.asarray), \
        build(pstudy, KernelSpec, lambda K: DenseKernel(torch.from_numpy(K)),
              torch.as_tensor)


CASES = {
    "grid_sir": lambda ds: _grid(ds, k=3, method="sir"),
    "grid_cold_budget": lambda ds: _grid(ds, k=3, method="cold",
                                         max_resident=1, lane_quantum=2,
                                         max_width=0),
    "grid_shrink": lambda ds: _grid(ds, k=3, method="sir", shrink_every=64,
                                    shrink_caps=(32, 64), max_width=4),
    "grid_pallas": lambda ds: _grid(ds, k=3, method="cold",
                                    source_backend="pallas_rbf",
                                    cache_bytes=10 ** 6),
    **{case: (lambda case: lambda ds: _custom(ds, case))(case) for case in (
        "pinned_and_managed", "storm", "over_budget", "thrash", "shrink",
        "dead", "cycle")},
}


def _findings(report):
    return sorted((f.rule, f.symbol, f.severity) for f in report)


@pytest.mark.parametrize("case", sorted(CASES))
def test_analysis_matches_the_references(ds, case):
    ref, port = CASES[case](ds)
    want = ref_check.analyze_plan(ref, backend="cpu", simulate="bounds")
    got = plan_check.analyze_plan(port, simulate="bounds")
    assert _findings(got.report) == _findings(want.report)
    assert got.program_count == want.program_count
    assert got.programs == want.programs
    assert got.max_width == want.max_width
    assert (got.pinned_bytes, got.peak_managed_bytes) == \
        (want.pinned_bytes, want.peak_managed_bytes)
    assert got.sim == want.sim
    assert {str(k): v for k, v in got.per_source.items()} == \
        {str(k): v for k, v in want.per_source.items()}


def test_check_plan_refuses_with_the_analysis(ds):
    _, port = CASES["pinned_and_managed"](ds)
    with pytest.raises(plan_check.PlanRejected) as err:
        plan_check.check_plan(port)
    assert {f.rule for f in err.value.analysis.report.errors} == \
        {"cache-infeasible-time"}
    assert err.value.analysis.to_json()["sim"]["min"]["peak_resident_bytes"] \
        > port.cache_bytes
    # the cost model's key is the plan's device type, cuda by default
    assert plan_check.plan_device_type(pstudy.Plan(sources={}, y=None)) == \
        "cuda"


@pytest.mark.parametrize("case", ["grid_cold_budget", "thrash", "shrink"])
def test_simulator_replays_the_live_pool(ds, case):
    """Under the exact oracle (the live run's iterations and, shrinking,
    its caps) the simulator's trace is the port's live pool's, event for
    event, as the reference's is its pool's."""
    _, port = CASES[case](ds)
    events, _ = plan_sim.dry_run(port, snapshot_every=2)
    oracle = plan_sim.oracle_from_trace(events,
                                        shrink=bool(port.shrink_every))
    sim = plan_sim.simulate_plan(port, oracle=oracle, snapshot_every=2)
    assert sim.events == events
    ref, _ = CASES[case](ds)
    ref_events, _ = ref_sim.dry_run(ref, snapshot_every=2)
    assert [e[0] for e in events] == [e[0] for e in ref_events]


def test_the_cases_cover_every_rule(ds):
    rules = set()
    for case in CASES.values():
        _, port = case(ds)
        rules |= {f.rule for f in plan_check.analyze_plan(
            port, simulate="bounds").report}
    assert rules >= {"invalid-plan", "recompile-storm", "cache-infeasible",
                     "cache-infeasible-time", "eviction-thrash",
                     "lane-unobserved"}
