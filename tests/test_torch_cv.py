"""``repro_torch.core.cv.run_cv`` against ``repro.core.cv.run_cv`` for the
four paper methods.

Per-fold accuracy must be identical and each fold's dual objective within
rel 1e-6. The iteration totals are printed side by side, not compared: the
port builds its own K (a torch matmul, not XLA's: the last bits differ) and
the SIR fallback draws its own priorities, so the SMO paths may differ
while the fixed point does not.
"""
import pytest

from repro.core.cv import run_cv as ref_run_cv
from repro.data.svm_suite import make_dataset
from repro_torch.convert import dataset_from_reference
from repro_torch.core.cv import run_cv


@pytest.mark.parametrize("name,n", [("heart", 150), ("adult", 300)])
@pytest.mark.parametrize("method", ["cold", "ato", "mir", "sir"])
def test_run_cv_matches_reference(name, n, method):
    ds = make_dataset(name, n_override=n)
    want = ref_run_cv(ds, k=5, method=method)
    got = run_cv(dataset_from_reference(ds), k=5, method=method,
                 device="cpu")
    print(f"{name} n={n} {method}: iterations port {got.total_iterations} "
          f"reference {want.total_iterations}; per fold "
          f"{[f.n_iter for f in got.folds]} vs "
          f"{[f.n_iter for f in want.folds]}")
    assert [f.fold for f in got.folds] == list(range(5))
    assert [f.seed_from for f in got.folds] == [f.seed_from
                                                for f in want.folds]
    assert [(f.acc_correct, f.acc_total) for f in got.folds] == \
        [(f.acc_correct, f.acc_total) for f in want.folds]
    for g, w in zip(got.folds, want.folds):
        assert g.converged and w.converged
        assert abs(g.objective - w.objective) <= 1e-6 * abs(w.objective)
