"""The port's dense SMO engine against ``repro.svm.smo_solve`` on the
reference's own K.

The bar is bitwise: alpha, f and n_iter equal, because the port rounds
every operation of the step as the reference does (the f-update as one FMA,
everything else op by op, exact first-index reduces).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.cv import _fold_masks
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm import smo_solve as ref_smo_solve
from repro_torch.svm import smo_solve


def _problem(name, n, k=10):
    """Fold 0 of the reference's k-fold split: its K, y and train mask, as
    numpy arrays."""
    ds = make_dataset(name, n_override=n)
    chunks = kfold_chunks(ds.n, k)
    m = chunks.size
    K = ref_kernel_matrix(jnp.asarray(ds.X[:m]), jnp.asarray(ds.X[:m]),
                          gamma=ds.gamma)
    return ds, np.array(K), ds.y[:m].astype(np.float64), \
        _fold_masks(chunks)[0]


def _port(K, y, mask):
    return torch.from_numpy(K), torch.from_numpy(y), torch.from_numpy(mask)


def _assert_same(a, b):
    np.testing.assert_array_equal(np.asarray(a.alpha), np.asarray(b.alpha))
    np.testing.assert_array_equal(np.asarray(a.f), np.asarray(b.f))
    assert int(a.n_iter) == int(b.n_iter)
    assert bool(a.converged) == bool(b.converged)


@pytest.mark.parametrize("name,n", [("heart", 270), ("adult", 600)])
@pytest.mark.parametrize("wss", ["2", "1"])
def test_smo_solve_bitwise_cold_fold0(name, n, wss):
    ds, K, y, mask = _problem(name, n)
    m = y.shape[0]
    want = ref_smo_solve(jnp.asarray(K), jnp.asarray(y), jnp.asarray(mask),
                         ds.C, jnp.zeros(m), -jnp.asarray(y), wss=wss)
    Kt, yt, mt = _port(K, y, mask)
    got = smo_solve(Kt, yt, mt, ds.C, torch.zeros(m, dtype=torch.float64),
                    -yt, wss=wss)
    _assert_same(got, want)
    assert bool(got.converged)
    for a, b in ((got.b_up, want.b_up), (got.b_low, want.b_low)):
        assert float(a) == float(b)


@pytest.fixture(scope="module")
def adult():
    ds, K, y, mask = _problem("adult", 600)
    return ds, *_port(K, y, mask)


def _cold(adult, **kw):
    ds, K, y, mask = adult
    return smo_solve(K, y, mask, ds.C, torch.zeros(y.shape[0],
                                                   dtype=torch.float64),
                     -y, **kw)


@pytest.mark.parametrize("chunk_iters", [64, 500])
def test_chunked_equals_monolithic_bitwise(adult, chunk_iters):
    mono = _cold(adult)
    chunks = []
    chun = _cold(adult, chunk_iters=chunk_iters, on_chunk=chunks.append)
    _assert_same(chun, mono)
    assert len(chunks) == int(mono.n_iter) // chunk_iters


def test_resume_from_snapshot_with_n_iter0(adult):
    """Restart from a mid-solve snapshot and land on the identical iterate
    sequence: alpha, f and the n_iter account."""
    ds, K, y, mask = adult
    snaps = []
    full = _cold(adult, chunk_iters=100, on_chunk=snaps.append)
    assert len(snaps) >= 2
    state = snaps[1]
    resumed = smo_solve(K, y, mask, ds.C, state.alpha, state.f,
                        chunk_iters=100, n_iter0=int(state.n_iter))
    _assert_same(resumed, full)


def test_max_iter_cap_respected_across_chunks(adult):
    capped = _cold(adult, max_iter=130, chunk_iters=50)
    mono = _cold(adult, max_iter=130)
    assert int(capped.n_iter) == 130 == int(mono.n_iter)
    assert not bool(capped.converged)
    _assert_same(capped, mono)


def test_converged_input_passes_through(adult):
    ds, K, y, mask = adult
    res = _cold(adult)
    again = smo_solve(K, y, mask, ds.C, res.alpha, res.f, chunk_iters=32)
    assert int(again.n_iter) == 0
    assert torch.equal(again.alpha, res.alpha)


def test_nan_in_f_halts_like_reference():
    """A NaN in f on an active row stops the solve at once with
    converged=False, in both packages."""
    ds, K, y, _ = _problem("heart", 64, k=4)
    m = y.shape[0]
    f0 = -y.copy()
    f0[3] = np.nan
    mask = np.ones(m, bool)
    want = ref_smo_solve(jnp.asarray(K), jnp.asarray(y), jnp.asarray(mask),
                         ds.C, jnp.zeros(m), jnp.asarray(f0), max_iter=50_000)
    Kt, yt, mt = _port(K, y, mask)
    got = smo_solve(Kt, yt, mt, ds.C, torch.zeros(m, dtype=torch.float64),
                    torch.from_numpy(f0), max_iter=50_000)
    assert not bool(got.converged) and not bool(want.converged)
    assert int(got.n_iter) == int(want.n_iter) == 0
    np.testing.assert_array_equal(got.f.numpy(), np.asarray(want.f))


# ---------------------------------------------------- row-streaming sources

def _rbf_sources(name="heart", n=150):
    from repro.svm import FusedRBF as RefFused
    from repro.svm import OnDemandRBF as RefOnDemand
    from repro.svm import PallasRBF as RefPallas
    from repro_torch.svm import FusedRBF, OnDemandRBF, PallasRBF
    ds = make_dataset(name, n_override=n)
    X = ds.X.astype(np.float64)
    ref = {"ondemand": RefOnDemand(jnp.asarray(X), ds.gamma),
           "fused": RefFused(jnp.asarray(X), ds.gamma),
           "pallas": RefPallas(jnp.asarray(X), ds.gamma)}
    Xt = torch.from_numpy(X)
    port = {"ondemand": OnDemandRBF(Xt, ds.gamma),
            "fused": FusedRBF(Xt, ds.gamma),
            "pallas": PallasRBF(Xt, ds.gamma)}
    return ds, X, ref, port


@pytest.mark.parametrize("kind", ["ondemand", "fused", "pallas"])
def test_rbf_sources_match_reference(kind):
    """rows2, kij, rows_at and matvec of the port's three RBF sources
    against the reference's, at 1e-12. The reference's K[i, j] is its
    interpret-mode ``PallasRBF.kij`` (the rows2 expression at row j)."""
    ds, X, ref, port = _rbf_sources()
    r, p = ref[kind], port[kind]
    n = X.shape[0]
    for i, j in [(0, 7), (31, 149), (80, 80)]:
        for a, b in zip(p.rows2(i, j), r.rows2(i, j)):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-12,
                                       rtol=0)
        np.testing.assert_allclose(float(p.kij(i, j)),
                                   float(ref["pallas"].kij(i, j)),
                                   atol=1e-12, rtol=0)
    idx = np.array([3, 0, 149, 77, 77])
    np.testing.assert_allclose(p.rows_at(torch.from_numpy(idx)).numpy(),
                               np.asarray(r.rows_at(jnp.asarray(idx))),
                               atol=1e-12, rtol=0)
    v = np.random.default_rng(3).normal(size=n)
    for block in (64, 2048):
        np.testing.assert_allclose(
            p.matvec(torch.from_numpy(v), block=block).numpy(),
            np.asarray(r.matvec(jnp.asarray(v), block=block)), atol=1e-12,
            rtol=0)
    assert p.nbytes == X.nbytes
    np.testing.assert_array_equal(p.diag().numpy(), np.ones(n))


def test_row_sources_refuse_to_solve_and_fused_needs_wss1():
    from repro_torch.svm.engine import solve
    ds, X, _, port = _rbf_sources(n=60)
    y = torch.from_numpy(ds.y.astype(np.float64))
    args = (y, torch.ones(60, dtype=torch.bool), ds.C,
            torch.zeros(60, dtype=torch.float64), -y)
    with pytest.raises(ValueError, match="WSS-1"):
        solve(port["pallas"], *args, wss="2")
    with pytest.raises(ValueError, match="serves kernel rows only"):
        solve(port["ondemand"], *args)


def _pallas_problem(name, n):
    from repro.svm import PallasRBF as RefPallas
    from repro_torch.svm import PallasRBF
    ds = make_dataset(name, n_override=n)
    X = ds.X.astype(np.float64)
    y = ds.y.astype(np.float64)
    mask = np.ones(n, bool)
    mask[: n // 5] = False
    return (ds, RefPallas(jnp.asarray(X), ds.gamma),
            PallasRBF(torch.from_numpy(X), ds.gamma), y, mask)


@pytest.mark.parametrize("name,n", [("heart", 150), ("adult", 200)])
def test_pallas_solve_matches_reference(name, n):
    """The matrix-free WSS-1 solve against the reference's PallasRBF solve:
    alpha and f within 1e-10 under an iteration cap of 50 (the dot products
    sum in another order, so not bitwise), and the same dual objective
    (rel 1e-6) and accuracy-relevant fixed point at convergence."""
    from repro.svm.engine import solve as ref_solve
    from repro_torch.svm.engine import solve
    ds, rsrc, psrc, y, mask = _pallas_problem(name, n)
    yt, mt = torch.from_numpy(y), torch.from_numpy(mask)
    for max_iter in (50, 5_000_000):
        want = ref_solve(rsrc, jnp.asarray(y), jnp.asarray(mask), ds.C,
                         jnp.zeros(n), -jnp.asarray(y), wss="1",
                         max_iter=max_iter)
        got = solve(psrc, yt, mt, ds.C, torch.zeros(n, dtype=torch.float64),
                    -yt, wss="1", max_iter=max_iter)
        print(f"{name} n={n} cap {max_iter}: iterations port "
              f"{int(got.n_iter)} reference {int(want.n_iter)}")
        if max_iter == 50:
            assert int(got.n_iter) == int(want.n_iter) == 50
            for a, b in ((got.alpha, want.alpha), (got.f, want.f)):
                np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                           atol=1e-10, rtol=0)
            continue
        assert bool(got.converged) and bool(want.converged)
        v = got.alpha * yt
        obj = float(got.alpha.sum() - 0.5 * v @ psrc.matvec(v))
        vr = want.alpha * jnp.asarray(y)
        ref_obj = float(jnp.sum(want.alpha) - 0.5 * vr @ rsrc.matvec(vr))
        assert abs(obj - ref_obj) <= 1e-6 * abs(ref_obj)


def test_engine_state_lane_helpers():
    from repro_torch.svm.engine import EngineState
    states = [EngineState(torch.full((4,), float(h)), torch.full((4,), -h),
                          torch.tensor(h), torch.tensor(h % 2 == 1))
              for h in range(3)]
    b = EngineState.stack(states)
    assert b.alpha.shape == (3, 4) and b.done.tolist() == [False, True,
                                                          False]
    for h in range(3):
        for a, c in zip(b.lane(h), states[h]):
            assert torch.equal(a, c)
    sub = b.gather([2, 0])
    assert sub.n_iter.tolist() == [2, 0]
    back = b.scatter([0, 2], sub)
    assert back.n_iter.tolist() == [2, 1, 0]
    assert b.n_iter.tolist() == [0, 1, 2]      # the original is untouched


def test_solve_batched_lanes_equal_single_solves():
    """``smo_solve_batched``: each fold bitwise its own ``smo_solve``, with
    per-lane C."""
    from repro_torch.svm import smo_solve_batched
    ds, K, y, _ = _problem("heart", 120, k=4)
    n = y.shape[0]
    Kt, yt = torch.from_numpy(K), torch.from_numpy(y)
    masks = torch.ones((3, n), dtype=torch.bool)
    for h in range(3):
        masks[h, h * 20:(h + 1) * 20] = False
    Cs = torch.tensor([ds.C, 4.0 * ds.C, 1.0], dtype=torch.float64)
    res = smo_solve_batched(Kt, yt, masks, Cs,
                            torch.zeros((3, n), dtype=torch.float64),
                            -yt.repeat(3, 1), chunk_iters=700)
    for h in range(3):
        one = smo_solve(Kt, yt, masks[h], float(Cs[h]),
                        torch.zeros(n, dtype=torch.float64), -yt)
        _assert_same(type(one)(*(t[h] for t in res)), one)
