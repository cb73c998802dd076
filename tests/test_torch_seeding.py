"""The port's seeders against the reference's, started from the
reference's own fold-h solution (``convert.result_from_reference``).

Tolerances, each measured with margin on these inputs:

* ``cold`` is exact; ``sir`` (same greedy picks, then the water-fill
  bisection whose sums run in another order) within atol 1e-10;
* ``mir``: the least squares is the same SVD pseudo-inverse as
  ``jnp.linalg.lstsq``, but the SVD routines differ in the last bits and
  the system is ill-conditioned, so atol 1e-10 * C (measured <= 2.2e-9 at
  C = 100); the seeded solve is then held to the reference's accuracy and
  objective;
* ``ato``: an LU of the bordered KKT system in another library, atol
  1e-12 * C (measured <= 6e-11 at C = 2182).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seeding as ref_seeding
from repro.core.cv import _fold_masks, _transition_idx
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm import smo_solve as ref_smo_solve
from repro.svm.smo import dual_objective as ref_dual_objective
from repro.svm.svc import bias_from_solution as ref_bias_from_solution
from repro.svm.svc import predict as ref_predict
from repro_torch.convert import result_from_reference
from repro_torch.core import seeding
from repro_torch.svm import (bias_from_solution, dual_objective, init_f,
                              predict, smo_solve)

ATOL = {"cold": lambda C: 0.0, "sir": lambda C: 1e-10,
        "mir": lambda C: 1e-10 * C, "ato": lambda C: 1e-12 * C}


class Transition:
    """Fold h-1's reference solution and the h-1 -> h index sets, in both
    packages' types."""

    def __init__(self, name, n, k, h):
        ds = make_dataset(name, n_override=n)
        chunks = kfold_chunks(ds.n, k)
        m = chunks.size
        self.ds, self.chunks, self.h = ds, chunks, h
        self.K = ref_kernel_matrix(jnp.asarray(ds.X[:m]),
                                   jnp.asarray(ds.X[:m]), gamma=ds.gamma)
        self.y = jnp.asarray(ds.y[:m], jnp.float64)
        self.masks = _fold_masks(chunks)
        self.prev = ref_smo_solve(self.K, self.y,
                                  jnp.asarray(self.masks[h - 1]), ds.C,
                                  jnp.zeros(m), -self.y)
        self.idx = _transition_idx(chunks, h - 1, h)
        self.t_prev = result_from_reference(
            {k: np.asarray(v) for k, v in self.prev._asdict().items()},
            device="cpu")
        self.tK = torch.from_numpy(np.array(self.K))
        self.ty = torch.from_numpy(np.array(self.y))
        self.t_idx = tuple(torch.from_numpy(np.array(a)) for a in self.idx)

    def reference(self, method):
        return np.asarray(ref_seeding.SEEDERS[method](
            self.K, self.y, self.ds.C, self.prev, *self.idx))

    def port(self, method, **kw):
        return seeding.SEEDERS[method](self.tK, self.ty, self.ds.C,
                                       self.t_prev, *self.t_idx, **kw)

    def sir_priority(self):
        """The reference's own fallback draw, handed to the port."""
        return np.array(jax.random.uniform(
            jax.random.PRNGKey(0), (self.idx[2].shape[0],), jnp.float64))


CASES = [("heart", 150, 5, 1), ("heart", 150, 5, 3), ("adult", 300, 5, 2)]


@pytest.fixture(scope="module", params=CASES,
                ids=lambda c: f"{c[0]}{c[1]}-h{c[3]}")
def tr(request):
    return Transition(*request.param)


@pytest.mark.parametrize("method", ["cold", "sir", "mir", "ato"])
def test_seed_keeps_box_and_equality(tr, method):
    kw = {"priority": tr.sir_priority()} if method == "sir" else {}
    a = tr.port(method, **kw).numpy()
    C, y = tr.ds.C, np.asarray(tr.y)
    S, R, T = (np.asarray(i) for i in tr.idx)
    assert a.min() >= 0.0 and a.max() <= C
    assert np.all(a[R] == 0.0)
    st = np.concatenate([S, T])
    assert abs(np.sum(y[st] * a[st])) <= 1e-10 * C


@pytest.mark.parametrize("method", ["cold", "sir", "mir", "ato"])
def test_seed_matches_reference(tr, method):
    kw = {"priority": tr.sir_priority()} if method == "sir" else {}
    got = tr.port(method, **kw).numpy()
    np.testing.assert_allclose(got, tr.reference(method), rtol=0,
                               atol=ATOL[method](tr.ds.C))


def test_mir_seeded_solve_matches_reference(tr):
    """MIR's seed is not bitwise, so hold what the paper claims: the seeded
    solve lands on the reference's objective (rel 1e-6) and accuracy."""
    ds, h = tr.ds, tr.h
    mask, test = tr.masks[h], tr.chunks[h]
    a_r = jnp.asarray(tr.reference("mir"))
    want = ref_smo_solve(tr.K, tr.y, jnp.asarray(mask), ds.C, a_r,
                         tr.K @ (a_r * tr.y) - tr.y)
    a_p = tr.port("mir")
    got = smo_solve(tr.tK, tr.ty, torch.from_numpy(mask), ds.C, a_p,
                    init_f(tr.tK, tr.ty, a_p))
    assert bool(got.converged) and bool(want.converged)
    obj_r = float(ref_dual_objective(tr.K, tr.y, want.alpha))
    obj_p = float(dual_objective(tr.tK, tr.ty, got.alpha))
    assert abs(obj_p - obj_r) <= 1e-6 * abs(obj_r)
    b_r = ref_bias_from_solution(want, tr.y, jnp.asarray(mask), ds.C)
    b_p = bias_from_solution(got, tr.ty, torch.from_numpy(mask), ds.C)
    pred_r = np.asarray(ref_predict(tr.K[test], tr.y, want.alpha, b_r))
    pred_p = predict(tr.tK[test], tr.ty, got.alpha, b_p).numpy()
    y_test = np.asarray(tr.y)[test]
    assert np.sum(pred_p == y_test) == np.sum(pred_r == y_test)


def test_sir_fallback_draws_from_generator(tr):
    """Without a priority vector the port draws one from a CPU generator:
    the same seed gives the same seed alphas, and seed 0 is the default."""
    a = tr.port("sir", generator=torch.Generator().manual_seed(0))
    b = tr.port("sir")
    assert torch.equal(a, b)


@pytest.mark.parametrize("n,target", [(40, 0.3), (64, -5.0), (17, 100.0)])
def test_water_fill_matches_reference(n, target):
    rng = np.random.default_rng(n)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    lo, hi = np.where(y > 0, 0.0, -2.0), np.where(y > 0, 2.0, 0.0)
    beta = rng.normal(size=n) * 2
    want = np.asarray(ref_seeding.water_fill(*(jnp.asarray(a) for a in
                                               (beta, lo, hi)), target))
    got = seeding.water_fill(*(torch.from_numpy(a) for a in (beta, lo, hi)),
                             target).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got.sum(), np.clip(target, lo.sum(), hi.sum()),
                               atol=1e-12)
