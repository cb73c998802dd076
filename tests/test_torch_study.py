"""The port's seed transforms, seeded plans, straggler policies and LOO
against the reference's, on inputs made from a seed (adult n = 200-300,
where the port's K and the reference's agree and the counts are exact).

Tolerances, stated per test: ``scale_seed_C`` and the LOO seeds within
1e-12 max(C, 1) (the water-fill and spill sums run in another order); the
ATO seeds within the ATO bar, 1e-12 C (an LU or SVD of another library,
and ``ato_seed_batch``'s batched products and LU); iteration counts and
accuracy exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seeding as ref_seeding
from repro.core.cv import _fold_masks, _transition_idx
from repro.core.cv import run_cv as ref_run_cv
from repro.core.cv import run_loo as ref_run_loo
from repro.core.study import Plan as RefPlan
from repro.core.study import run_plan as ref_run_plan
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import DenseKernel as RefDenseKernel
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm import smo_solve as ref_smo_solve
from repro.svm import smo_solve_batched as ref_smo_solve_batched
from repro_torch.convert import (dataset_from_reference,
                                 result_from_reference, source_from_reference)
from repro_torch.core import seeding
from repro_torch.core.cv import run_cv, run_loo
from repro_torch.core.study import Plan, run_plan
from repro_torch.svm.engine import DenseKernel, SMOResult, solve
from repro_torch.svm.smo import init_f


def _np(a):
    return np.array(a)


def _t(a):
    return torch.from_numpy(np.array(a))


class Fold0:
    """Adult's fold-0 reference solution and the 0 -> 1 transition, in both
    packages' types."""

    def __init__(self, n=250, k=5):
        ds = make_dataset("adult", n_override=n)
        chunks = kfold_chunks(ds.n, k)
        m = chunks.size
        self.ds, self.chunks = ds, chunks
        self.K = ref_kernel_matrix(jnp.asarray(ds.X[:m]),
                                   jnp.asarray(ds.X[:m]), gamma=ds.gamma)
        self.y = jnp.asarray(ds.y[:m], jnp.float64)
        self.masks = _fold_masks(chunks)
        self.prev = ref_smo_solve(self.K, self.y, jnp.asarray(self.masks[0]),
                                  ds.C, jnp.zeros(m), -self.y)
        self.idx = _transition_idx(chunks, 0, 1)
        self.t_prev = result_from_reference(
            {k: _np(v) for k, v in self.prev._asdict().items()},
            device="cpu")
        self.tK, self.ty = _t(self.K), _t(self.y)
        self.t_idx = tuple(_t(a) for a in self.idx)


@pytest.fixture(scope="module")
def fold0():
    return Fold0()


def test_transform_and_seeder_names_equal_the_reference():
    assert sorted(seeding.TRANSFORMS) == sorted(ref_seeding.TRANSFORMS) \
        == ["fold", "loo_avg", "loo_top", "scale_C"]
    assert sorted(seeding.SEEDERS) == sorted(ref_seeding.SEEDERS)
    assert seeding.TRANSFORMS["scale_C"].kernel_free
    assert not any(getattr(seeding.TRANSFORMS[k], "kernel_free", False)
                   for k in ("fold", "loo_avg", "loo_top"))


@pytest.mark.parametrize("scale", [0.01, 0.25, 4.0, 100.0])
def test_scale_seed_C_matches_reference(fold0, scale):
    """Within 1e-12 max(C_new, 1): the water-fill's sums run in another
    order. Rows off the mask stay 0 and sum(y alpha) is 0."""
    C_old, C_new = fold0.ds.C, scale * fold0.ds.C
    mask = fold0.masks[0]
    want = _np(ref_seeding.scale_seed_C(fold0.prev.alpha, fold0.y, C_old,
                                        C_new, jnp.asarray(mask)))
    got = seeding.scale_seed_C(fold0.t_prev.alpha, fold0.ty, C_old, C_new,
                               torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * max(C_new, 1.0))
    assert float(got[~torch.from_numpy(mask)].abs().max()) == 0.0
    assert abs(float((fold0.ty * got).sum())) <= 1e-12 * max(C_new, 1.0)


@pytest.mark.parametrize("method", ["avg", "top"])
@pytest.mark.parametrize("t", [0, 17, 101, 199])
def test_loo_seeds_match_reference(fold0, method, t):
    """avg_seed_loo / top_seed_loo from the full fold-0 solution, removing
    instance t: within 1e-12 max(C, 1) of the reference; row t is 0."""
    ref_fn = getattr(ref_seeding, f"{method}_seed_loo")
    fn = getattr(seeding, f"{method}_seed_loo")
    C = fold0.ds.C
    want = _np(ref_fn(fold0.K, fold0.y, C, fold0.prev.alpha, jnp.asarray(t)))
    got = fn(fold0.tK, fold0.ty, C, fold0.t_prev.alpha, t)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * max(C, 1.0))
    assert float(got[t]) == 0.0


def test_loo_spills_plain_versions():
    """The spills on their own, on a case worked by hand: AVG spreads the
    residual over the free rows with room, round by round; TOP fills the
    rows in order."""
    from repro_torch.kernels.ref import avg_spill_ref, top_spill_ref
    f64 = torch.float64
    lo = torch.tensor([0.0, -1.0, 0.0, -1.0], dtype=f64)
    hi = torch.tensor([1.0, 0.0, 1.0, 0.0], dtype=f64)
    beta = torch.tensor([0.5, -0.5, 0.9, 0.0], dtype=f64)
    free0 = torch.tensor([True, True, True, False])
    out = avg_spill_ref(beta, lo, hi, free0, torch.tensor(0.4, dtype=f64))
    # round 1: rows 0-2 have room upward, 0.4/3 each, row 2 takes its 0.1;
    # round 2: rows 0 and 1 take the 1/30 left, half each
    np.testing.assert_allclose(out.numpy(), [0.65, -0.35, 1.0, 0.0],
                               atol=1e-15)
    order = torch.tensor([2, 0, 1, 3])
    out = top_spill_ref(order, beta, lo, hi, torch.tensor(0.4, dtype=f64))
    np.testing.assert_allclose(out.numpy(), [0.8, -0.5, 1.0, 0.0],
                               atol=1e-15)


def test_ato_seed_ref_matches_reference(fold0):
    """The host-side pinv oracle: within the ATO bar, 1e-12 C (an SVD of
    another library)."""
    C = fold0.ds.C
    want = _np(ref_seeding.ato_seed_ref(fold0.K, fold0.y, C, fold0.prev,
                                        *fold0.idx))
    got = seeding.ato_seed_ref(fold0.tK, fold0.ty, C, fold0.t_prev,
                               *fold0.t_idx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12 * C)


@pytest.fixture(scope="module")
def ato_row(fold0):
    """A 3-lane C row (0.01, 1, 100 x C) solved on fold 0 by the
    reference's batched solve, in both packages' types."""
    m = fold0.y.shape[0]
    Cs = [s * fold0.ds.C for s in (0.01, 1.0, 100.0)]
    mask = jnp.tile(jnp.asarray(fold0.masks[0])[None], (3, 1))
    prev = ref_smo_solve_batched(fold0.K, fold0.y, mask, jnp.asarray(Cs),
                                 jnp.zeros((3, m)), jnp.tile(-fold0.y, (3, 1)))
    return Cs, prev, SMOResult(*(_t(a) for a in prev))


@pytest.mark.parametrize("bucket_by_lane", [True, False])
def test_ato_seed_batch_matches_reference(fold0, ato_row, bucket_by_lane):
    """Each lane of the batched ramp within the ATO bar (1e-12 C_l) of the
    reference's lane, and of the port's solo ato_seed on that lane."""
    Cs, prev, t_prev = ato_row
    want = _np(ref_seeding.ato_seed_batch(fold0.K, fold0.y, jnp.asarray(Cs),
                                          prev, *fold0.idx,
                                          bucket_by_lane=bucket_by_lane))
    got = seeding.ato_seed_batch(fold0.tK, fold0.ty, Cs, t_prev,
                                 *fold0.t_idx, bucket_by_lane=bucket_by_lane)
    assert got.shape == (3, fold0.y.shape[0])
    for lane, C in enumerate(Cs):
        np.testing.assert_allclose(got[lane].numpy(), want[lane], rtol=0,
                                   atol=1e-12 * C)
        solo = seeding.ato_seed(fold0.tK, fold0.ty, C,
                                SMOResult(*(a[lane] for a in t_prev)),
                                *fold0.t_idx)
        np.testing.assert_allclose(got[lane].numpy(), solo.numpy(), rtol=0,
                                   atol=1e-12 * C)


def _seeded_plans(device_plan):
    """The same seeded plan for both packages: two kernel sources (gamma/2
    and 2 gamma); a's result seeds b on the OTHER source (scale_C), c
    (fold, SIR), e (loo_avg) and f (loo_top) on its own; d starts cold
    held by an ``after`` edge on c."""
    ds = make_dataset("adult", n_override=200)
    chunks = kfold_chunks(ds.n, 4)
    m = chunks.size
    X = jnp.asarray(ds.X[:m])
    Ks = [ref_kernel_matrix(X, X, gamma=s * ds.gamma) for s in (0.5, 2.0)]
    y = jnp.asarray(ds.y[:m], jnp.float64)
    masks = _fold_masks(chunks)
    S, R, T = _transition_idx(chunks, 0, 1)
    full = np.ones(m, bool)

    def lanes(P, src, arr):
        p = P(sources={0: src(Ks[0]), 1: src(Ks[1])}, y=arr(y),
              chunk_iters=64, **device_plan)
        z = arr(jnp.zeros(m))
        p.lane("a", source=0, train_mask=arr(masks[0]), C=ds.C, alpha0=z,
               f0=-arr(y))
        p.lane("b", source=1, train_mask=arr(masks[0]), C=4 * ds.C,
               dep="a", transform="scale_C",
               params=dict(C_old=ds.C, train_mask=arr(masks[0])))
        p.lane("c", source=0, train_mask=arr(masks[1]), C=ds.C, dep="a",
               transform="fold", params=dict(method="sir", S_idx=arr(S),
                                             R_idx=arr(R), T_idx=arr(T)))
        p.lane("d", source=0, train_mask=arr(masks[2]), C=ds.C, alpha0=z,
               f0=-arr(y), after="c")
        for lid, tr, t in (("e", "loo_avg", 3), ("f", "loo_top", 150)):
            mask = full.copy()
            mask[t] = False
            p.lane(lid, source=0, train_mask=arr(mask), C=ds.C, dep="a",
                   transform=tr, params={"t": t})
        for lid, h in (("a", 0), ("c", 1), ("d", 2)):
            p.evaluate(lid, chunks[h])
        return p
    return lanes, ds.C


def test_seeded_run_plan_matches_reference():
    """A seeded plan (cross-source dep, every transform, an after edge):
    per lane the reference's n_iter and evaluation, alpha within 1e-9 C
    (the seeds differ from the reference's in the last bits)."""
    lanes, C = _seeded_plans({})
    want = ref_run_plan(lanes(RefPlan, RefDenseKernel, lambda a: a),
                        analysis="off")
    t_lanes, _ = _seeded_plans({"device": "cpu"})
    got = run_plan(t_lanes(
        Plan, lambda K: source_from_reference(K=K, device="cpu"), _t))
    assert set(got.results) == set(want.results)
    for lid in want.results:
        assert got.stats[lid].n_iter == want.stats[lid].n_iter, lid
        assert got.stats[lid].converged and want.stats[lid].converged
        np.testing.assert_allclose(got.results[lid].alpha.numpy(),
                                   _np(want.results[lid].alpha), rtol=0,
                                   atol=1e-9 * 4 * C)
    assert got.evals == want.evals
    assert got.stats["b"].seed_s > 0 and got.stats["a"].seed_s == 0


class _Bare:
    """A source with neither K nor row slabs nor a matvec."""

    def to(self, device):
        return self


def test_validate_plan_names_the_lane_and_the_source():
    """Unknown transforms, and transforms or evaluations that need a dense
    K on a K-less source, fail at entry by lane and by source; scale_C
    (kernel-free) runs on a K-less source, f0 from its streaming matvec."""
    from repro_torch.svm.engine import PallasRBF
    ds = make_dataset("adult", n_override=40)
    X = torch.from_numpy(ds.X)
    y = torch.from_numpy(ds.y.astype(np.float64))
    mask = torch.ones(40, dtype=torch.bool)
    z = torch.zeros(40, dtype=torch.float64)
    src = {"dense": source_from_reference(K=np.eye(40), device="cpu"),
           "rows": PallasRBF(X, ds.gamma)}

    def plan(key, **lane):
        p = Plan(sources=src, y=y, wss="1", device="cpu")
        p.lane("a", source=key, train_mask=mask, C=1.0, alpha0=z, f0=-y)
        p.lane("b", source=key, train_mask=mask, C=2.0, dep="a", **lane)
        return p

    with pytest.raises(ValueError, match="lane 'b': unknown transform "
                                         "'nope'"):
        run_plan(plan("dense", transform="nope"))
    for tr, params in (("fold", {}), ("loo_avg", {"t": 0}),
                       ("loo_top", {"t": 0})):
        with pytest.raises(ValueError, match=f"lane 'b': transform '{tr}' "
                                             "needs a dense kernel source "
                                             r"\(source 'rows' has no K\)"):
            run_plan(plan("rows", transform=tr, params=params))
    p = Plan(sources={"bare": _Bare()}, y=y, device="cpu")
    p.lane("a", train_mask=mask, C=1.0, alpha0=z, f0=-y)
    p.evaluate("a", np.arange(4))
    with pytest.raises(ValueError, match="lane 'a': evaluation needs a dense "
                                         r"kernel source \(source 'bare'"):
        run_plan(p)
    # kernel-free: b starts from scale_C's alpha with f0 = K (alpha y) - y
    # by the source's matvec
    res = run_plan(plan("rows", transform="scale_C",
                        params=dict(C_old=1.0, train_mask=mask)))
    assert res.stats["a"].converged and res.stats["b"].converged
    assert res.stats["b"].seed_s > 0


@pytest.mark.parametrize("policy", ["strict", "best_available"])
def test_run_cv_straggler_policies_match_reference(policy):
    """Fold 2 unavailable as a seed: the same seed_from fold by fold (the
    nearest completed fold, the earlier on a tie, under best_available)
    and the reference's iterations and per-fold accuracy. At n=200 the
    port's K gives the reference's counts in every cold and SIR fold; at
    n=300 cold fold 3 takes one iteration more (the port builds its own
    K, ROADMAP Queue 3)."""
    ds = make_dataset("adult", n_override=200)
    kw = dict(k=5, method="sir", straggler_policy=policy,
              unavailable_folds=frozenset({2}))
    want = ref_run_cv(ds, **kw)
    got = run_cv(dataset_from_reference(ds), device="cpu", **kw)
    seed_from = {"strict": [-1, 0, 1, -1, 3],
                 "best_available": [-1, 0, 1, 1, 3]}[policy]
    assert [f.seed_from for f in want.folds] == seed_from
    assert [f.seed_from for f in got.folds] == seed_from
    assert [f.n_iter for f in got.folds] == [f.n_iter for f in want.folds]
    assert [(f.acc_correct, f.acc_total) for f in got.folds] == \
        [(f.acc_correct, f.acc_total) for f in want.folds]
    assert all(f.init_time > 0 for f in got.folds if f.seed_from >= 0)


@pytest.mark.parametrize("method", ["cold", "avg", "top", "ato", "mir",
                                    "sir"])
def test_run_loo_matches_reference(method):
    """Six LOO rounds of adult n=200: the reference's base_iterations,
    iterations and accuracy."""
    ds = make_dataset("adult", n_override=200)
    want = ref_run_loo(ds, method=method, rounds=6)
    got = run_loo(dataset_from_reference(ds), method=method, rounds=6,
                  device="cpu")
    for key in ("dataset", "method", "rounds", "base_iterations",
                "iterations", "accuracy"):
        assert got[key] == want[key], key


@pytest.fixture(scope="module")
def loo_ato_chain():
    """The reference's LOO ATO chain on adult n=1000 (the full SVM, round
    0 by ``loo_avg``, round t from round t-1 by ATO), 20 rounds: per
    round its prev result, index sets, seed and iterations."""
    from repro.svm.smo import init_f as ref_init_f
    ds = make_dataset("adult", n_override=1000)
    n = ds.n
    K = ref_kernel_matrix(jnp.asarray(ds.X), jnp.asarray(ds.X),
                          gamma=ds.gamma)
    y = jnp.asarray(ds.y, jnp.float64)
    prev = ref_smo_solve(K, y, jnp.ones(n, bool), ds.C, jnp.zeros(n), -y,
                         max_iter=2_000_000)
    rounds = []
    for t in range(20):
        if t == 0:
            idx, seed = None, ref_seeding.avg_seed_loo(K, y, ds.C,
                                                       prev.alpha,
                                                       jnp.asarray(0))
        else:
            idx = tuple(jnp.asarray(a) for a in (
                np.delete(np.arange(n), [t - 1, t]), [t], [t - 1]))
            seed = ref_seeding.ato_seed(K, y, ds.C, prev, *idx)
        mask = np.ones(n, bool)
        mask[t] = False
        res = ref_smo_solve(K, y, jnp.asarray(mask), ds.C, seed,
                            ref_init_f(K, y, seed), max_iter=2_000_000)
        rounds.append((prev, idx, np.array(seed), mask, int(res.n_iter)))
        prev = res
    return ds.C, _t(K), _t(y), rounds


@pytest.mark.parametrize("t", range(1, 20))
def test_loo_ato_gap_is_in_the_seeds(loo_ato_chain, t):
    """Round t of adult's LOO ATO chain: the port's ATO seed from the
    reference's round t-1 is within the ATO bar (1e-12 C) of the
    reference's (its LU is another library's), and from the reference's
    seed the port's solver takes the reference's iterations exactly; so
    where the port's own chain takes another count (it does in a few
    rounds), the seeds' last bits moved it."""
    C, K, y, rounds = loo_ato_chain
    prev, idx, want, mask, n_iter = rounds[t]
    tp = result_from_reference({k: _np(v) for k, v in prev._asdict().items()},
                               device="cpu")
    own = seeding.ato_seed(K, y, C, tp, *(_t(i) for i in idx))
    np.testing.assert_allclose(own.numpy(), want, rtol=0, atol=1e-12 * C)
    a0 = _t(want)
    res = solve(DenseKernel(K), y, _t(mask), C, a0, init_f(K, y, a0),
                max_iter=2_000_000)
    assert int(res.n_iter) == n_iter


def test_run_loo_rejects_unknown_method():
    ds = dataset_from_reference(make_dataset("adult", n_override=20))
    with pytest.raises(ValueError, match="unknown LOO method 'nope'"):
        run_loo(ds, method="nope", device="cpu")
