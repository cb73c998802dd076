"""``repro_torch.core.grid`` against ``repro.core.grid`` on adult n=200
(where the port's K gives the reference's counts), and the grid's own
contracts in the port: a cell equals ``run_cv`` on its (C, gamma), and a
lane's result is bitwise the same under the cross-gamma pool, the
per-gamma pools and any residency budget. At adult n=1000 a witness of
where the gamma = 0.25 row's few iterations of difference come from: the
order of the seeds' sums, not the solver.

Iterations, correct counts and convergence are compared exactly.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from repro.core.grid import _check_grid_args as ref_check_grid_args
from repro.core.grid import grid_plans as ref_grid_plans
from repro.core import seeding as ref_seeding
from repro.core.cv import _fold_masks, _transition_idx
from repro.core.grid import run_grid as ref_run_grid
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm import smo_solve as ref_smo_solve
from repro.svm.smo import init_f as ref_init_f
from repro_torch.convert import dataset_from_reference, result_from_reference
from repro_torch.core import seeding
from repro_torch.core.cv import run_cv
from repro_torch.core.grid import (_check_grid_args, _merge_occupancy,
                                   grid_plans, run_grid)
from repro_torch.core.study import run_plan
from repro_torch.svm.engine import DenseKernel, solve
from repro_torch.svm.smo import init_f

N, K = 200, 4


@pytest.fixture(scope="module")
def ds():
    return make_dataset("adult", n_override=N)


def _axes(ds):
    return [0.25 * ds.C, ds.C], [0.5 * ds.gamma, ds.gamma]


def _cells(rep):
    return [(c.C, c.gamma, c.iterations, c.acc_correct, c.acc_total,
             c.converged) for c in rep.cells]


@pytest.mark.parametrize("kw", [
    dict(method="sir"),
    dict(method="cold", pool="per_gamma"),
    dict(method="sir", seed_across_C=True, max_resident=1),
    dict(method="cold", source_backend="pallas_rbf", max_resident=1),
], ids=["sir", "cold-per_gamma", "sir-seed_across_C-lru1", "cold-pallas"])
def test_run_grid_matches_reference(ds, kw):
    """Every cell's iterations, correct count and convergence equal the
    reference's, and so do the residency account and the best cell."""
    Cs, gammas = _axes(ds)
    want = ref_run_grid(ds, Cs, gammas, k=K, **kw)
    got = run_grid(dataset_from_reference(ds), Cs, gammas, k=K,
                   device="cpu", **kw)
    assert _cells(got) == _cells(want)
    assert all(c.converged for c in got.cells)
    for key in ("materializations", "evictions", "peak_resident"):
        assert got.resident[key] == want.resident[key], key
    assert (got.best().C, got.best().gamma) == (want.best().C,
                                                want.best().gamma)
    assert got.rows()[0].keys() == want.rows()[0].keys()
    assert (got.dataset, got.method, got.k, got.n) == \
        (want.dataset, want.method, want.k, want.n)


def test_grid_cell_equals_run_cv(ds):
    """A cell of the grid is run_cv on that cell's (C, gamma): the same
    iterations fold by fold and the same correct counts."""
    pds = dataset_from_reference(ds)
    Cs, gammas = _axes(ds)
    sres = run_plan(grid_plans(pds, Cs, gammas, k=K, device="cpu")[0])
    for gi, gamma in enumerate(gammas):
        for ci, C in enumerate(Cs):
            rep = run_cv(dataclasses.replace(pds, C=C, gamma=gamma), k=K,
                         method="sir", device="cpu")
            lanes = [(gi, ci, h) for h in range(K)]
            assert [sres.stats[lid].n_iter for lid in lanes] == \
                [f.n_iter for f in rep.folds]
            assert [sres.evals[lid][0] for lid in lanes] == \
                [f.acc_correct for f in rep.folds]


def test_grid_pools_and_budgets_bitwise(ds):
    """Each lane's alpha, f and n_iter are bitwise the same under the
    cross-gamma pool, the per-gamma pools and the cross-gamma pool with
    one kernel resident at a time (which re-materializes: a kernel is a
    pure function of (X, gamma))."""
    pds = dataset_from_reference(ds)
    Cs, gammas = _axes(ds)
    runs = {}
    for name, kw in (("cross", {}), ("per", dict(pool="per_gamma")),
                     ("lru1", dict(max_resident=1))):
        results, stats = {}, []
        for plan in grid_plans(pds, Cs, gammas, k=K, device="cpu", **kw):
            sres = run_plan(plan)
            results.update(sres.results)
            stats.append(sres.source_stats)
        runs[name] = results, stats
    base = runs["cross"][0]
    for name in ("per", "lru1"):
        other = runs[name][0]
        assert set(other) == set(base)
        for lid, res in base.items():
            assert torch.equal(res.alpha, other[lid].alpha), (name, lid)
            assert torch.equal(res.f, other[lid].f), (name, lid)
            assert int(res.n_iter) == int(other[lid].n_iter)
    assert runs["lru1"][1][0]["peak_resident"] == 1
    assert runs["lru1"][1][0]["evictions"] >= 1


def test_grid_plans_declare_the_references_graph(ds):
    """The same lane ids, sources, C values, edges, transforms and params
    keys as the reference's plans, for both pools and seed_across_C."""
    Cs, gammas = _axes(ds)
    for kw in (dict(), dict(pool="per_gamma", seed_across_C=True),
               dict(method="cold")):
        want = ref_grid_plans(ds, Cs, gammas, k=K, **kw)
        got = grid_plans(dataset_from_reference(ds), Cs, gammas, k=K,
                         device="cpu", **kw)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert list(g.sources) == list(w.sources)
            assert [(s.id, s.source, s.C, s.dep, s.transform, s.after,
                     sorted(s.params)) for s in g.lanes] == \
                [(s.id, s.source, s.C, s.dep, s.transform, s.after,
                  sorted(s.params)) for s in w.lanes]
            assert [e.lane for e in g.evals] == [e.lane for e in w.evals]


@pytest.mark.parametrize("args", [("nope", "dense", "sir"),
                                  ("cross_gamma", "nope", "sir"),
                                  ("per_gamma", "pallas_rbf", "sir")])
def test_check_grid_args_messages_match_reference(args):
    with pytest.raises(ValueError) as want:
        ref_check_grid_args(*args)
    with pytest.raises(ValueError) as got:
        _check_grid_args(*args)
    assert str(got.value) == str(want.value)


def test_merge_occupancy_sums_programs_and_merges_sources():
    rows = [{"chunks": 2, "mean_live_width": 3.0, "mean_packed_width": 4.0,
             "peak_width": 4, "programs": 2,
             "per_source": {"0": {"chunks": 2, "mean_live_width": 3.0,
                                  "peak_live_width": 4}}},
            {"chunks": 6, "mean_live_width": 1.0, "mean_packed_width": 1.0,
             "peak_width": 1, "programs": 1,
             "per_source": {"0": {"chunks": 6, "mean_live_width": 1.0,
                                  "peak_live_width": 1}}}]
    got = _merge_occupancy(rows)
    assert got["chunks"] == 8 and got["programs"] == 3
    assert got["mean_live_width"] == 1.5 and got["peak_width"] == 4
    assert got["per_source"]["0"] == {"chunks": 8, "mean_live_width": 1.5,
                                      "peak_live_width": 4}
    assert _merge_occupancy([]) is None


def test_grid_plans_hold_their_arrays_on_the_device(ds):
    plan = grid_plans(dataset_from_reference(ds), [1.0], [0.5], k=K,
                      device="cpu")[0]
    assert plan.device == torch.device("cpu")
    assert plan.sources[0].X.device.type == "cpu"
    assert plan.sources[0].n == (N // K) * K
    S_idx = plan.lanes[1].params["S_idx"]
    assert S_idx.device.type == "cpu" and S_idx.dtype == torch.int64


class _XlaSums(TorchFunctionMode):
    """Every whole-tensor float64 ``sum`` taken by XLA (``jnp.sum``), the
    reference's reduction order, in place of torch's."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func in (torch.Tensor.sum, torch.sum) and len(args) == 1 \
                and not kwargs and args[0].dtype == torch.float64:
            return torch.from_numpy(np.array(jnp.sum(jnp.asarray(
                args[0].numpy()))))
        return func(*args, **(kwargs or {}))


@pytest.fixture(scope="module")
def sir_row_chain():
    """The reference's SIR fold chain (k=5) of adult n=1000's grid cell
    (C x 0.25, gamma x 0.5), where the port's own run takes a few
    iterations more than the reference's: for each transition h-1 -> h,
    the reference's fold h-1 result, its index sets, its seed and fold h's
    iterations from it."""
    ds = make_dataset("adult", n_override=1000)
    C, gamma, k = 0.25 * ds.C, 0.5 * ds.gamma, 5
    chunks = kfold_chunks(ds.n, k)
    m = chunks.size
    K = ref_kernel_matrix(jnp.asarray(ds.X[:m]), jnp.asarray(ds.X[:m]),
                          gamma=gamma)
    y = jnp.asarray(ds.y[:m], jnp.float64)
    masks = _fold_masks(chunks)
    prev = ref_smo_solve(K, y, jnp.asarray(masks[0]), C, jnp.zeros(m), -y)
    steps = []
    for h in range(1, k):
        idx = _transition_idx(chunks, h - 1, h)
        seed = ref_seeding.sir_seed(K, y, C, prev, *idx)
        res = ref_smo_solve(K, y, jnp.asarray(masks[h]), C, seed,
                            ref_init_f(K, y, seed))
        steps.append((prev, idx, np.array(seed), masks[h], int(res.n_iter)))
        prev = res
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return C, t(K), t(y), t, steps


@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_grid_gap_sir_seed_is_the_references_with_xla_sums(sir_row_chain,
                                                           h):
    """The port's SIR seed from the reference's fold h-1 equals the
    reference's bit for bit once every float64 sum is XLA's, and within
    the SIR bar (1e-10) with torch's own: the seeds differ in the order
    of their sums (water_fill's, repair_equality's and SIR's target)."""
    C, K, y, t, steps = sir_row_chain
    prev, idx, want, _, _ = steps[h - 1]
    tp = result_from_reference({k: np.array(v)
                                for k, v in prev._asdict().items()},
                               device="cpu")
    args = (K, y, C, tp, *(t(i) for i in idx))
    with _XlaSums():
        xla = seeding.sir_seed(*args)
    assert torch.equal(xla, t(want))
    own = seeding.sir_seed(*args)
    np.testing.assert_allclose(own.numpy(), want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("h", [1, 2, 3, 4])
def test_grid_gap_solver_from_references_seed_takes_its_count(
        sir_row_chain, h):
    """From the reference's seed of fold h, the port's solver takes the
    reference's iterations exactly: the row's gap is in the seeds."""
    C, K, y, t, steps = sir_row_chain
    _, _, seed, mask, n_iter = steps[h - 1]
    a0 = t(seed)
    res = solve(DenseKernel(K), y, t(mask), C, a0, init_f(K, y, a0))
    assert int(res.n_iter) == n_iter
