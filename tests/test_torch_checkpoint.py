"""The port's checkpoints against the reference's: the same tree saved by
either manager gives the same record on disk; a study record written
mid-flight by either package's ``run_plan`` resumes in the other's bitwise;
``run_cv``'s mid-fold records cross over too; and the port's drivers resume
their own records where an uninterrupted run would end."""
import json
import os
import shutil
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from repro.checkpoint import CheckpointManager as RefManager
from repro.checkpoint import namespace_path as ref_namespace_path
from repro.core import study as rstudy
from repro.core.cv import _fold_masks
from repro.core.cv import run_cv as ref_run_cv
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import DenseKernel as RDense
from repro.svm import kernel_matrix as ref_kernel_matrix

from repro_torch.checkpoint import CheckpointManager, namespace_path
from repro_torch.checkpoint import manager as manager_mod
from repro_torch.core import cv as pcv
from repro_torch.core import study as pstudy
from repro_torch.core.grid import run_grid
from repro_torch.svm import DenseKernel as PDense


def _trees():
    rng = np.random.default_rng(3)
    study = {"alpha": rng.random((3, 7)), "f": rng.random((3, 7)),
             "n_iter": np.array([4, 9, 0], np.int64),
             "done": np.array([True, False, False]),
             "active": rng.random((3, 7)) < 0.5,
             "shrunk": np.array([False, True, False]),
             "no_shrink": np.array([False, False, True]),
             "unshrinks": np.array([0, 1, 4], np.int32)}
    done = {"alpha": rng.random(7), "f": rng.random(7),
            "n_iter": np.int64(12), "converged": np.bool_(True),
            "b_up": np.float64(-0.5), "b_low": np.float64(-0.25)}
    nested = {"a": [np.arange(4.0), (np.ones(2, np.int32),)],
              "b": {"c": np.float64(3.5)}, "z": (np.zeros(1),)}
    return {"study": study, "done": done, "nested": nested}


def _record(directory):
    step = sorted(os.listdir(directory))[0]
    with np.load(os.path.join(directory, step, "arrays.npz")) as data:
        arrays = {k: data[k] for k in data.files}
    with open(os.path.join(directory, step, "meta.json")) as fh:
        return arrays, json.load(fh)


@pytest.mark.parametrize("name", ["study", "done", "nested"])
def test_a_tree_saves_to_the_references_record(tmp_path, name):
    """The same tree (numpy leaves for the reference, tensors for the
    port) gives equal ``arrays.npz`` contents and an equal ``meta.json``;
    each package restores the other's record."""
    tree = as_jax = as_torch = _trees()[name]
    if name != "nested":
        as_jax = {k: jnp.asarray(v) for k, v in tree.items()}
        as_torch = {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}
    extra = {"phase": "study_mid", "lane_ids": [[0, "a"], 1]}
    RefManager(str(tmp_path / "ref")).save(5, as_jax, extra,
                                           retain_class="study")
    CheckpointManager(str(tmp_path / "port")).save(5, as_torch, extra,
                                                   retain_class="study")
    want, want_meta = _record(tmp_path / "ref")
    got, got_meta = _record(tmp_path / "port")
    assert got_meta == want_meta
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key])
    _, flat, got_extra = CheckpointManager(str(tmp_path / "ref")).restore()
    assert got_extra == extra and sorted(flat) == sorted(want)
    _, flat, _ = RefManager(str(tmp_path / "port")).restore()
    for key in want:
        np.testing.assert_array_equal(np.asarray(flat[key]), want[key])


@pytest.mark.parametrize("parts", [("alice", "grid"), ("a/b", "p:1"),
                                   ("tenant 7", "plan.v2")])
def test_namespace_path_is_the_references(parts):
    assert namespace_path("/r", *parts) == ref_namespace_path("/r", *parts)
    with pytest.raises(ValueError):
        namespace_path("/r", "..")


def test_restore_into_a_target_keeps_tensor_prototypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = {"w": torch.arange(6.0).reshape(2, 3),
            "meta": [torch.tensor(3, dtype=torch.int32), np.ones(2)]}
    mgr.save(1, tree, {"ok": True})
    step, got, extra = mgr.restore(target=tree)
    assert step == 1 and extra == {"ok": True}
    assert isinstance(got["w"], torch.Tensor) and torch.equal(got["w"],
                                                              tree["w"])
    assert got["meta"][0].dtype == torch.int32
    np.testing.assert_array_equal(got["meta"][1], np.ones(2))


def test_commit_marker_retention_classes_and_latest_of_class(tmp_path):
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for s in range(3):
        mgr.save(s, {"a": np.arange(3)}, retain_class="done")
    for s in range(10, 16):
        mgr.save(s, {"a": np.arange(3)}, retain_class="mid")
    assert mgr.all_steps() == [1, 2, 14, 15]
    os.makedirs(os.path.join(str(tmp_path), "step_0000000099"))
    assert mgr.latest_step() == 15       # no COMMIT marker: not a record
    fresh = CheckpointManager(str(tmp_path), max_to_keep=2)
    assert fresh.steps_of_class("done") == [1, 2]
    assert fresh.restore_latest_of_class("done")[0] == 2
    assert fresh.restore_latest_of_class("study") is None


def test_save_copies_to_host_before_its_writer_runs(tmp_path, monkeypatch):
    """A tensor mutated in place after ``save`` returns (the pool updates
    its states in place) leaves the record as it was at the call: the
    writer thread is held until the mutation is done."""
    go = threading.Event()
    real = manager_mod.save_pytree

    def held(*args, **kwargs):
        go.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(manager_mod, "save_pytree", held)
    mgr = CheckpointManager(str(tmp_path))
    state = {"alpha": torch.zeros(5, dtype=torch.float64),
             "n_iter": torch.tensor(7)}
    mgr.save(3, state, blocking=False)
    state["alpha"].add_(1.0)
    state["n_iter"].add_(1)
    go.set()
    mgr.wait()
    _, flat, _ = mgr.restore()
    np.testing.assert_array_equal(flat["alpha"], np.zeros(5))
    assert int(flat["n_iter"]) == 7


# ------------------------------------------------------ study records


@pytest.fixture(scope="module")
def shared():
    """heart n=120: a K the reference built, shared by both packages (the
    engine is bitwise on a shared K)."""
    ds = make_dataset("heart", n_override=120)
    chunks = kfold_chunks(ds.n, 4, seed=0)
    n = chunks.size
    X = jnp.asarray(ds.X[:n])
    K = np.array(ref_kernel_matrix(X, X, gamma=ds.gamma))
    y = np.asarray(ds.y[:n], np.float64)
    return ds, chunks, K, y


def _cold_plan(mod, source, y, chunks, C, **knobs):
    """Cold lanes of four Cs, lane 3 held behind lane 0: its result does
    not depend on either package's seed arithmetic."""
    masks = _fold_masks(chunks)
    plan = mod.Plan(sources={"k": source}, y=y, chunk_iters=64,
                    lane_quantum=2, **knobs)
    for h in range(4):
        plan.lane(("l", h), train_mask=masks[h], C=C * (0.5 + h),
                  alpha0=np.zeros(y.shape[0]), f0=-y,
                  after=("l", 0) if h == 3 else None)
        plan.evaluate(("l", h), chunks[h])
    return plan


def _crash(manager_dir, key: str = "done") -> np.ndarray:
    """Keep the study records up to the first one where ``key`` holds for
    some lanes and not others (a crash mid-flight); returns that row."""
    steps = sorted(os.listdir(manager_dir))
    for i, name in enumerate(steps):
        with np.load(os.path.join(manager_dir, name, "arrays.npz")) as data:
            flags = data[key]
        if flags.any() and not flags.all():
            for later in steps[i + 1:]:
                shutil.rmtree(os.path.join(manager_dir, later))
            return flags
    raise AssertionError(f"no record with mixed {key!r}")


def _same_bits(got, want) -> None:
    assert set(got) == set(want)
    for lid in want:
        g, w = got[lid], want[lid]
        np.testing.assert_array_equal(np.asarray(g.alpha), np.asarray(w.alpha))
        np.testing.assert_array_equal(np.asarray(g.f), np.asarray(w.f))
        assert int(g.n_iter) == int(w.n_iter)
        assert bool(g.converged) == bool(w.converged)


META = {"study": "cross", "tol": 1e-3}


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_study_record_resumes_across_packages_bitwise(tmp_path, shared,
                                                      writer):
    """A record written mid-flight by one package's ``run_plan`` (some
    lanes retired, some live) resumes in the other's, under another width,
    bitwise the uninterrupted run."""
    ds, chunks, K, y = shared
    ref_plan = _cold_plan(rstudy, RDense(jnp.asarray(K)), y, chunks, ds.C,
                          max_width=2)
    port_plan = _cold_plan(pstudy, PDense(torch.from_numpy(K)), y, chunks,
                           ds.C, max_width=1, device="cpu")
    want = rstudy.run_plan(ref_plan, analysis="off")
    root = str(tmp_path / "ckpt")
    if writer == "reference":
        rstudy.run_plan(ref_plan, checkpoint=rstudy.StudyCheckpoint(
            manager=RefManager(root, max_to_keep=1000), meta=META),
            analysis="off")
    else:
        pstudy.run_plan(port_plan, checkpoint=pstudy.StudyCheckpoint(
            manager=CheckpointManager(root, max_to_keep=1000), meta=META))
    _crash(root)
    if writer == "reference":
        got = pstudy.run_plan(port_plan, checkpoint=pstudy.StudyCheckpoint(
            manager=CheckpointManager(root, max_to_keep=1000), meta=META))
    else:
        got = rstudy.run_plan(ref_plan, checkpoint=rstudy.StudyCheckpoint(
            manager=RefManager(root, max_to_keep=1000), meta=META),
            analysis="off")
    assert got.restored and len(got.restored) < 4
    _same_bits(got.results, want.results)
    assert got.evals == want.evals


def test_study_record_of_another_run_is_refused(tmp_path, shared):
    ds, chunks, K, y = shared
    plan = _cold_plan(pstudy, PDense(torch.from_numpy(K)), y, chunks, ds.C,
                      device="cpu")
    mgr = CheckpointManager(str(tmp_path), max_to_keep=1000)
    pstudy.run_plan(plan, checkpoint=pstudy.StudyCheckpoint(
        manager=mgr, meta=META))
    with pytest.raises(ValueError, match="belongs to run"):
        pstudy.run_plan(plan, checkpoint=pstudy.StudyCheckpoint(
            manager=mgr, meta={**META, "tol": 1e-4}))


def test_shrinking_study_resumes_bitwise(tmp_path, shared):
    """Under shrinking a record carries the shrink ledger (active masks,
    flags, unshrinks); a resume under another width re-enters each lane's
    compact bucket and ends bitwise where the uninterrupted run does."""
    ds, chunks, K, y = shared
    knobs = dict(shrink_every=64, shrink_quantum=16, device="cpu")
    plan = _cold_plan(pstudy, PDense(torch.from_numpy(K)), y, chunks, ds.C,
                      max_width=2, **knobs)
    want = pstudy.run_plan(plan, analysis="off")
    root = str(tmp_path / "ckpt")
    pstudy.run_plan(plan, checkpoint=pstudy.StudyCheckpoint(
        manager=CheckpointManager(root, max_to_keep=1000), meta=META))
    _crash(root, "shrunk")                       # a compact lane resumes
    again = _cold_plan(pstudy, PDense(torch.from_numpy(K)), y, chunks, ds.C,
                       max_width=1, **knobs)
    got = pstudy.run_plan(again, checkpoint=pstudy.StudyCheckpoint(
        manager=CheckpointManager(root, max_to_keep=1000), meta=META))
    _same_bits(got.results, want.results)


# --------------------------------------------------------- run_cv records


@pytest.fixture(scope="module")
def adult():
    return make_dataset("adult", n_override=200)


def _shared_K(monkeypatch):
    """The port's run_cv over the reference's K (bitwise on a shared K)."""
    def reference_K(X, Z, kind="rbf", gamma=1.0):
        K = ref_kernel_matrix(jnp.asarray(X.numpy()), jnp.asarray(Z.numpy()),
                              kind=kind, gamma=gamma)
        return torch.from_numpy(np.array(K))

    monkeypatch.setattr(pcv, "kernel_matrix", reference_K)


def _mid_crash(root: str, fold: int) -> None:
    """Drop every record after fold ``fold``'s second mid-fold record."""
    steps = sorted(int(name[5:]) for name in os.listdir(root))
    mids = [s for s in steps if s % pcv._FOLD_STRIDE
            and s // pcv._FOLD_STRIDE == fold]
    assert len(mids) >= 2
    for s in steps:
        if s > mids[1]:
            shutil.rmtree(os.path.join(root, f"step_{s:010d}"))


@pytest.mark.parametrize("writer", ["reference", "port"])
@pytest.mark.parametrize("method", ["cold", "sir"])
def test_run_cv_mid_fold_record_resumes_across_packages(tmp_path, monkeypatch,
                                                        adult, writer,
                                                        method):
    """adult n=200: a crash inside fold 1 leaves fold 0's done record and
    fold 1's mid-fold record; the other package resumes them, over one K.
    Every method takes the reference's per-fold iterations and held-out
    counts; the cold chain is bitwise the resuming package's uninterrupted
    run (equal objectives: the two packages' objectives sum in other
    orders)."""
    _shared_K(monkeypatch)
    kw = dict(k=4, method=method, chunk_iters=4 if method == "sir" else 32)
    want = ref_run_cv(adult, **kw)
    root = str(tmp_path / "cv")
    if writer == "reference":
        ref_run_cv(adult, checkpoint_manager=RefManager(root, 1000), **kw)
        solo = pcv.run_cv(adult, device="cpu", **kw)
    else:
        pcv.run_cv(adult, checkpoint_manager=CheckpointManager(root, 1000),
                   device="cpu", **kw)
        solo = want
    _mid_crash(root, fold=1)
    if writer == "reference":
        got = pcv.run_cv(adult, checkpoint_manager=CheckpointManager(
            root, 1000), device="cpu", **kw)
    else:
        got = ref_run_cv(adult, checkpoint_manager=RefManager(root, 1000),
                         **kw)
    assert [f.fold for f in got.folds] == [0, 1, 2, 3]
    assert [f.restored for f in got.folds] == [True, False, False, False]
    assert [f.seed_from for f in got.folds] == \
        [f.seed_from for f in want.folds]
    assert [f.n_iter for f in got.folds] == [f.n_iter for f in want.folds]
    assert [f.acc_correct for f in got.folds] == \
        [f.acc_correct for f in want.folds]
    if method == "cold":
        assert [f.objective for f in got.folds] == \
            [f.objective for f in solo.folds]


def test_run_cv_resume_matches_uninterrupted(tmp_path, adult):
    """Done records only (no chunking): a run killed after fold 1 restores
    folds 0-1 and recomputes the rest, reporting the uninterrupted run's
    folds; shrinking with mid-fold records is refused."""
    full = pcv.run_cv(adult, k=4, method="sir", device="cpu")
    root = str(tmp_path / "cv")
    pcv.run_cv(adult, k=4, method="sir", device="cpu",
               checkpoint_manager=CheckpointManager(root, 100))
    for s in sorted(os.listdir(root))[-2:]:
        shutil.rmtree(os.path.join(root, s))
    resumed = pcv.run_cv(adult, k=4, method="sir", device="cpu",
                         checkpoint_manager=CheckpointManager(root, 100))
    assert [f.restored for f in resumed.folds] == [True, True, False, False]
    for a, b in zip(full.folds, resumed.folds):
        assert (a.fold, a.seed_from, a.n_iter, a.acc_correct,
                a.objective) == (b.fold, b.seed_from, b.n_iter,
                                 b.acc_correct, b.objective)
    with pytest.raises(ValueError, match="shrink ledger"):
        pcv.run_cv(adult, k=4, device="cpu", shrink_every=64, chunk_iters=64,
                   checkpoint_manager=CheckpointManager(root, 100))


def test_batched_grid_and_loo_records_resume(tmp_path, adult):
    """``run_cv_batched``'s batch records, ``run_grid``'s and ``run_loo``'s
    study records: a run killed half-way resumes to the uninterrupted
    run's iterations and counts."""
    def resume(run, name):
        full = run(None)
        mgr = CheckpointManager(str(tmp_path / name), max_to_keep=1000)
        run(mgr)
        _crash(mgr.directory)
        return full, run(CheckpointManager(str(tmp_path / name),
                                           max_to_keep=1000))

    full, got = resume(lambda m: pcv.run_cv_batched(
        adult, k=4, chunk_iters=64, max_width=2, device="cpu",
        checkpoint_manager=m), "batched")
    assert any(f.restored for f in got.folds)
    assert [(f.n_iter, f.objective) for f in got.folds] == \
        [(f.n_iter, f.objective) for f in full.folds]
    with pytest.raises(ValueError, match="repacked"):
        pcv.run_cv_batched(adult, k=4, schedule="batched", device="cpu",
                           checkpoint_manager=CheckpointManager(
                               str(tmp_path / "x")))

    full, got = resume(lambda m: run_grid(
        adult, [0.5, 2.0], [adult.gamma], k=3, chunk_iters=64,
        device="cpu", checkpoint_manager=m), "grid")
    assert [(c.iterations, c.acc_correct) for c in got.cells] == \
        [(c.iterations, c.acc_correct) for c in full.cells]

    full, got = resume(lambda m: pcv.run_loo(
        adult, method="sir", rounds=4, chunk_iters=64, device="cpu",
        checkpoint_manager=m), "loo")
    for key in ("base_iterations", "iterations", "accuracy"):
        assert got[key] == full[key]
