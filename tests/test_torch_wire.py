"""The study wire format of the port against the reference's: the same plan,
built from the same numpy arrays in either package, serializes to the same
JSON; a wire plan round-trips; the parse-time gates refuse what the
reference's refuse; ``source_identity`` is the same tuple in both; the
support-vector-only evaluation counts what the full one counts."""
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.core import study as rstudy
from repro.core.cv import _fold_masks, _transition_idx
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import DenseKernel as RDense
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm.sources import KernelSpec as RSpec
from repro.svm.sources import source_identity as ref_identity

from repro_torch.core import study as pstudy
from repro_torch.svm import DenseKernel as PDense
from repro_torch.svm.sources import KernelSpec as PSpec
from repro_torch.svm.sources import source_identity

N, K_FOLDS = 120, 4


@pytest.fixture(scope="module")
def data():
    ds = make_dataset("heart", n_override=N)
    chunks = kfold_chunks(ds.n, K_FOLDS, seed=0)
    n = chunks.size
    X = np.asarray(ds.X[:n])
    y = np.asarray(ds.y[:n], np.float64)
    K = np.array(ref_kernel_matrix(jnp.asarray(X), jnp.asarray(X),
                                   gamma=ds.gamma))
    return ds, chunks, X, y, K


def _plan(mod, spec_cls, dense_cls, data, kind):
    """One plan of each shape the wire carries, built from numpy arrays."""
    ds, chunks, X, y, K = data
    n = y.shape[0]
    masks = _fold_masks(chunks)
    if kind == "dense":
        sources, ys = {"k": dense_cls(K)}, y
    elif kind == "ymap":
        sources = {(0, 0.5): spec_cls(X=X, gamma=ds.gamma, n=n),
                   (1, 2.0): spec_cls(X=X, gamma=2 * ds.gamma, n=n - 4)}
        ys = {(0, 0.5): y, (1, 2.0): y}
    else:
        sources, ys = {"g": spec_cls(X=X, gamma=ds.gamma, n=n)}, y
    knobs = dict(chunk_iters=64, lane_quantum=2)
    if kind == "shrink":
        knobs.update(shrink_every=64, shrink_quantum=16, shrink_caps=(32, 64),
                     shrink_on_seed=False, sv_eval=True, max_width=3,
                     max_resident=1, cache_bytes=10 ** 6)
    if kind == "pallas":
        knobs.update(wss="1", source_backend="pallas_rbf", tol=1e-4)
    plan = mod.Plan(sources=sources, y=ys, **knobs)
    for key in sources:
        tag = key if kind == "ymap" else "l"
        plan.lane((tag, 0), source=key, train_mask=masks[0], C=ds.C,
                  alpha0=np.zeros(n), f0=-y, max_iter=10 ** 6)
        for h in range(1, 3):
            S, R, T = (np.asarray(a) for a in _transition_idx(chunks,
                                                             h - 1, h))
            plan.lane((tag, h), source=key, train_mask=masks[h], C=ds.C,
                      dep=(tag, h - 1), transform="fold",
                      params=dict(method="sir", S_idx=S, R_idx=R, T_idx=T),
                      after=(tag, 0) if h == 2 else None)
        plan.lane((tag, "scaled"), source=key, train_mask=masks[0],
                  C=2.0 * ds.C, dep=(tag, 0), transform="scale_C",
                  params=dict(C_old=float(ds.C), train_mask=masks[0]))
        for h in range(3):
            plan.evaluate((tag, h), chunks[h])
    return plan


KINDS = ("spec", "dense", "ymap", "shrink", "pallas")


@pytest.mark.parametrize("kind", KINDS)
def test_plan_json_equals_the_references(data, kind):
    ref = _plan(rstudy, RSpec, lambda K: RDense(jnp.asarray(K)), data, kind)
    port = _plan(pstudy, PSpec, lambda K: PDense(torch.from_numpy(K)), data,
                 kind)
    want = json.dumps(rstudy.plan_to_dict(ref), sort_keys=True)
    assert json.dumps(pstudy.plan_to_dict(port), sort_keys=True) == want


@pytest.mark.parametrize("kind", KINDS)
def test_wire_plan_round_trips(data, kind):
    """Parsed onto host tensors for the device it is given, a wire plan
    serializes back to the same JSON (the reference's, too)."""
    ref = _plan(rstudy, RSpec, lambda K: RDense(jnp.asarray(K)), data, kind)
    wire = json.loads(json.dumps(rstudy.plan_to_dict(ref)))
    plan = pstudy.plan_from_dict(wire, device="cpu")
    assert plan.device == "cpu"
    assert all(isinstance(t, torch.Tensor) for t in
               [s.train_mask for s in plan.lanes] + [
                   s.X if isinstance(s, PSpec) else s.K
                   for s in plan.sources.values()])
    assert json.dumps(pstudy.plan_to_dict(plan), sort_keys=True) == \
        json.dumps(wire, sort_keys=True)
    assert rstudy.plan_to_dict(rstudy.plan_from_dict(
        pstudy.plan_to_dict(plan))) == rstudy.plan_to_dict(ref)


def _mutate(wire, path, value):
    node = wire
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    return wire


GATES = [
    ((("lanes", 1, "transform"), "warp"), "unknown transform"),
    ((("sources", 0, 1, "kind"), "sigmoid"), "unknown source kind"),
    ((("sources", 0, 1, "kind_tag"), "opaque"), "unknown source entry tag"),
    ((("sources", 0, 1, "gamma"), float("nan")), "non-finite"),
    ((("lanes", 0, "C"), float("inf")), "non-finite"),
    ((("tol",), float("nan")), "non-finite"),
    ((("tol",), 0.0), "non-positive"),
    ((("lanes", 3, "params", "C_old"), float("-inf")), "non-finite"),
    ((("__plan__",), 2), "not a wire plan"),
]


@pytest.mark.parametrize("gate", GATES, ids=lambda g: g[1] + str(g[0][0]))
def test_parse_time_gates_match_the_references(data, gate):
    (path, value), match = gate
    ref = _plan(rstudy, RSpec, lambda K: RDense(jnp.asarray(K)), data, "spec")
    wire = _mutate(json.loads(json.dumps(rstudy.plan_to_dict(ref))), path,
                   value)
    with pytest.raises(ValueError, match=match) as port_err:
        pstudy.plan_from_dict(wire, device="cpu")
    with pytest.raises(ValueError) as ref_err:
        rstudy.plan_from_dict(wire)
    assert str(port_err.value) == str(ref_err.value)


def test_result_image_equals_the_references(data):
    ds, chunks, X, y, K = data
    masks = _fold_masks(chunks)
    ref = rstudy.run_plan(_cold_plan(rstudy, RDense(jnp.asarray(K)), y,
                                     masks, ds.C), analysis="off")
    for lid, r in ref.results.items():
        want = rstudy.result_to_dict(r)
        got = pstudy.result_from_dict(json.loads(json.dumps(want)))
        assert pstudy.result_to_dict(got) == want
        assert got.alpha.dtype == torch.float64 and got.n_iter.dtype == \
            torch.int64 and got.converged.dtype == torch.bool


def _cold_plan(mod, source, y, masks, C, **knobs):
    plan = mod.Plan(sources={"k": source}, y=y, chunk_iters=64,
                    lane_quantum=2, **knobs)
    for h in range(masks.shape[0]):
        plan.lane(h, train_mask=masks[h], C=C * (1 + h),
                  alpha0=np.zeros(y.shape[0]), f0=-y)
    return plan


@pytest.mark.parametrize("n_rows", [None, 100])
@pytest.mark.parametrize("labels", [False, True])
def test_source_identity_equals_the_references(data, n_rows, labels):
    ds, chunks, X, y, K = data
    yy = y if labels else None
    spec = dict(X=X, gamma=ds.gamma, kind="rbf", n=n_rows)
    assert source_identity(PSpec(**{**spec, "X": torch.from_numpy(X)}),
                           None if yy is None else torch.from_numpy(yy)) \
        == ref_identity(RSpec(**{**spec, "X": jnp.asarray(X)}), yy)
    assert source_identity(PDense(torch.from_numpy(K)), yy) == \
        ref_identity(RDense(jnp.asarray(K)), yy)
    assert source_identity(object(), yy) is None


def test_sv_eval_counts_what_the_full_evaluation_counts():
    """``Plan.sv_eval`` gathers the support vectors at a bucketed capacity
    below n; its held-out counts equal the full product's and the
    reference's own ``sv_eval`` counts."""
    ds = make_dataset("adult", n_override=300)
    chunks = kfold_chunks(ds.n, 3, seed=0)
    n = chunks.size
    X = np.asarray(ds.X[:n])
    y = np.asarray(ds.y[:n], np.float64)
    K = np.array(ref_kernel_matrix(jnp.asarray(X), jnp.asarray(X),
                                   gamma=ds.gamma))
    masks = _fold_masks(chunks)

    def plan_of(mod, source, **knobs):
        plan = _cold_plan(mod, source, y, masks, ds.C, max_width=1, **knobs)
        for h in range(masks.shape[0]):
            plan.evaluate(h, chunks[h])
        return plan

    port = {sv: pstudy.run_plan(plan_of(
        pstudy, PDense(torch.from_numpy(K)), sv_eval=sv, device="cpu"))
        for sv in (False, True)}
    svs = max(int((r.alpha > 0).sum()) for r in port[True].results.values())
    assert -(-svs // 128) * 128 < n    # gathered, not the fallback
    assert port[True].evals == port[False].evals
    want = rstudy.run_plan(plan_of(rstudy, RDense(jnp.asarray(K)),
                                   sv_eval=True), analysis="off")
    assert port[True].evals == want.evals
