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
