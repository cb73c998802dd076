"""The port's ``SVC`` estimator (``svm/svc.py``) against the reference's,
on the CPU, at heart n = 120: the same iterations, alpha within 1e-10 C,
the same predictions and score; label mapping, ``gamma="scale"``, the
linear kernel, the binary check, ``cross_validate`` and shrinking fits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data.svm_suite import make_dataset
from repro.svm.svc import SVC as RefSVC
from repro_torch.core.cv import run_cv
from repro_torch.data.svm_suite import SVMDataset
from repro_torch.svm import SVC


@pytest.fixture(scope="module")
def data():
    ds = make_dataset("heart", n_override=120)
    return ds, ds.X[:90], ds.y[:90], ds.X[90:], ds.y[90:]


@pytest.fixture(scope="module")
def fitted(data):
    ds, X, y, _, _ = data
    ref = RefSVC(C=ds.C, gamma=ds.gamma).fit(X, y)
    port = SVC(C=ds.C, gamma=ds.gamma, device="cpu").fit(X, y)
    return ref, port


def test_fit_matches_reference(fitted, data):
    ds = data[0]
    ref, port = fitted
    assert port.n_iter_ == ref.n_iter_
    assert port.converged_ and ref.converged_
    np.testing.assert_allclose(port.result_.alpha.numpy(),
                               np.asarray(ref.result_.alpha),
                               atol=1e-10 * ds.C, rtol=0)
    assert abs(float(port.b_) - float(ref.b_)) <= 1e-10


def test_predict_and_score_match_reference(fitted, data):
    _, X, y, Xt, yt = data
    ref, port = fitted
    for A, b in ((Xt, yt), (X, y)):
        assert np.array_equal(port.predict(A), np.asarray(ref.predict(A)))
        assert port.score(A, b) == ref.score(A, b)
    np.testing.assert_allclose(port.decision_function(Xt).numpy(),
                               np.asarray(ref.decision_function(Xt)),
                               atol=1e-9, rtol=0)


def test_labels_map_and_map_back(data):
    ds, X, y, Xt, _ = data
    lab = np.where(y > 0, 7, 3)
    port = SVC(C=ds.C, gamma=ds.gamma, device="cpu").fit(X, lab)
    ref = RefSVC(C=ds.C, gamma=ds.gamma).fit(X, lab)
    assert list(port.classes_) == [3, 7]
    pred = port.predict(Xt)
    assert set(np.unique(pred)) <= {3, 7}
    assert np.array_equal(pred, np.asarray(ref.predict(Xt)))


def test_gamma_scale_is_the_reference_float(data):
    ds, X, y, _, _ = data
    port = SVC(C=ds.C, device="cpu")
    ref = RefSVC(C=ds.C)
    want = ref._resolve_gamma(jnp.asarray(X))
    got = port._resolve_gamma(torch.as_tensor(X))
    # the variance's sum runs in torch's order, not XLA's: a few ulps
    assert abs(got - want) <= 1e-14 * want
    # the population variance, not torch's default unbiased one
    n = X.size
    unbiased = 1.0 / (X.shape[1] * float(torch.var(torch.as_tensor(X))))
    assert abs(unbiased - want) > abs(got - want)
    assert abs(unbiased * n / (n - 1) - want) <= 1e-12 * want


def test_linear_fits_and_refuses_cross_validate(data):
    ds, X, y, Xt, _ = data
    port = SVC(C=1.0, kind="linear", device="cpu").fit(X, y)
    ref = RefSVC(C=1.0, kind="linear").fit(X, y)
    assert port.converged_
    assert np.array_equal(port.predict(Xt), np.asarray(ref.predict(Xt)))
    with pytest.raises(ValueError, match="rbf"):
        port.cross_validate(X, y, k=3)


def test_three_classes_raise(data):
    _, X, y, _, _ = data
    lab = np.arange(X.shape[0]) % 3
    with pytest.raises(ValueError, match="binary"):
        SVC(device="cpu").fit(X, lab)


@pytest.mark.parametrize("method", ["cold", "sir"])
def test_cross_validate_is_run_cv(data, method):
    ds = data[0]
    X, y = ds.X[:120], ds.y[:120]
    port = SVC(C=ds.C, gamma=ds.gamma, device="cpu")
    rep = port.cross_validate(X, y, k=3, method=method)
    own = run_cv(SVMDataset("svc", X, y.astype(np.int64), ds.C, ds.gamma),
                 k=3, method=method, device="cpu")
    assert [f.acc_correct for f in rep.folds] == \
        [f.acc_correct for f in own.folds]
    assert [f.n_iter for f in rep.folds] == [f.n_iter for f in own.folds]


def test_shrink_fit_same_svs(data):
    """The reference's ``test_svc_shrink_fit_same_svs``: a shrinking fit
    keeps the support vectors and predictions of the plain fit."""
    ds, X, y, Xt, _ = data
    plain = SVC(C=ds.C, gamma=ds.gamma, device="cpu").fit(X, y)
    shr = SVC(C=ds.C, gamma=ds.gamma, device="cpu", shrink_every=32,
              shrink_quantum=16).fit(X, y)
    assert shr.converged_
    assert torch.equal(shr.result_.alpha > 0, plain.result_.alpha > 0)
    assert np.array_equal(shr.predict(Xt), plain.predict(Xt))
