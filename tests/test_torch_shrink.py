"""The port's active-set shrinking (``svm/shrink.py``, the pool's shrink
path, the shrink knobs of the drivers) against the reference's, on the CPU.

Inputs come from ``repro.data.svm_suite`` through the reference's kernel,
converted, at heart n = 120 and adult n = 200, k = 3. The compact phase of
a shrunk solve is a pure function of the active values, so ``solve_shrunk``
must be bitwise the reference's up to its first reconstruction of f. The
reconstruction ``K @ (alpha * y) - y`` sums in another library's order,
so after it the port is held to the same support vectors, the objective
within 1e-6 relative, the full-set gap within tol and f within 1e-10 of
its own ``K @ (alpha * y) - y``; the witness test hands the port the
reference's reconstructed f and then asks for the reference's run bit
for bit.
"""
import gc
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import seeding as ref_seeding
from repro.core.cv import _fold_masks as ref_fold_masks
from repro.core.cv import _transition_idx as ref_transition_idx
from repro.core.cv import run_cv as ref_run_cv
from repro.core.cv import run_cv_batched as ref_run_cv_batched
from repro.core.grid import run_grid as ref_run_grid
from repro.data.svm_suite import kfold_chunks, make_dataset
from repro.svm import cost_model as ref_cost_model
from repro.svm import kernel_matrix as ref_kernel_matrix
from repro.svm import shrink as ref_shrink
from repro.svm.engine import DenseKernel as RefDense
from repro.svm.engine import PallasRBF as RefPallas
from repro.svm.smo import init_f as ref_init_f
from repro_torch.core.cv import run_cv, run_cv_batched
from repro_torch.core.grid import run_grid
from repro_torch.kernels import ops
from repro_torch.svm import cost_model, shrink
from repro_torch.svm import engine
from repro_torch.svm.engine import (DenseKernel, EngineState, PallasRBF,
                                    chunk_batched_sources, smo_chunk, solve,
                                    stack_sources)
from repro_torch.svm.scheduler import LanePool
from repro_torch.svm.sources import SourceCache
from repro_torch.svm.smo import dual_objective

KW = dict(shrink_every=64, shrink_quantum=16, chunk_iters=64)


def _t(a):
    return torch.from_numpy(np.array(a))


class Case:
    """A dataset's kernel, labels and fold masks in both packages' types."""

    def __init__(self, name, n, k=3):
        ds = make_dataset(name, n_override=n)
        chunks = kfold_chunks(ds.n, k)
        m = chunks.size
        self.ds, self.chunks, self.n = ds, chunks, m
        self.X = jnp.asarray(ds.X[:m])
        self.K = ref_kernel_matrix(self.X, self.X, gamma=ds.gamma)
        self.y = jnp.asarray(ds.y[:m], jnp.float64)
        self.masks = ref_fold_masks(chunks)
        self.tK, self.ty, self.tX = _t(self.K), _t(self.y), _t(self.X)

    def seeded(self, method):
        """Fold 1's seed from the reference's fold-0 solution: (alpha0, f0)
        in both packages' types."""
        prev = ref_shrink.solve_shrunk(
            RefDense(self.K), self.y, jnp.asarray(self.masks[0]), self.ds.C,
            jnp.zeros(self.n), -self.y, shrink_every=0)
        S, R, T = ref_transition_idx(self.chunks, 0, 1)
        a0 = ref_seeding.SEEDERS[method](self.K, self.y, self.ds.C, prev,
                                         S, R, T)
        f0 = ref_init_f(self.K, self.y, a0)
        return (a0, f0), (_t(a0), _t(f0))


@pytest.fixture(scope="module")
def heart():
    return Case("heart", 120)


@pytest.fixture(scope="module")
def adult():
    return Case("adult", 200)


# ----------------------------------------------------------- the helpers


@pytest.mark.parametrize("quantum", [1, 16, 128])
def test_cap_helpers_match_reference(quantum):
    for caps in (None, (40, 96, 150), (300,)):
        for n in (50, 120, 200, 257):
            assert shrink.possible_caps(n, quantum, caps) == \
                ref_shrink.possible_caps(n, quantum, caps)
            for m in range(0, n + 2, 7):
                assert shrink.pick_cap(m, n, quantum, caps) == \
                    ref_shrink.pick_cap(m, n, quantum, caps)
                assert shrink.bucket_cap(m, quantum) == \
                    ref_shrink.bucket_cap(m, quantum)
    assert shrink.DEFAULT_SHRINK_EVERY == ref_shrink.DEFAULT_SHRINK_EVERY
    assert shrink.UNSHRINK_LIMIT == ref_shrink.UNSHRINK_LIMIT


@pytest.mark.parametrize("name,method", [("heart", "sir"), ("adult", "sir"),
                                         ("adult", "ato"), ("heart", "cold")])
def test_active_set_matches_reference_on_seeds(name, method, request):
    c = request.getfixturevalue(name)
    (a0, f0), (ta, tf) = c.seeded(method)
    mask = jnp.asarray(c.masks[1])
    act, gap = ref_shrink.active_set(a0, f0, c.y, mask, c.ds.C)
    tact, tgap = shrink.active_set(ta, tf, c.ty, _t(mask), c.ds.C)
    assert torch.equal(tact, _t(act))
    assert float(tgap) == float(gap)
    assert torch.equal(shrink.seed_active_mask(ta, tf, c.ty, _t(mask),
                                               c.ds.C),
                       _t(ref_shrink.seed_active_mask(a0, f0, c.y, mask,
                                                      c.ds.C)))


# ----------------------------------------------------- the solo driver


class _Stop(Exception):
    pass


def _first_reconstruction(mod, *args, **kw):
    """(alpha, f) that ``mod.solve_shrunk`` reaches its first
    reconstruction with, and the f it reconstructs there."""
    orig, got = mod.reconstruct_f, {}

    def hook(source, y, alpha):
        got["alpha"] = np.array(alpha)
        got["f"] = np.array(orig(source, y, alpha))
        raise _Stop

    mod.reconstruct_f = hook
    try:
        mod.solve_shrunk(*args, **kw)
    except _Stop:
        pass
    finally:
        mod.reconstruct_f = orig
    return got


def _solve_both(c, fold, start, **kw):
    mask = jnp.asarray(c.masks[fold])
    (a0, f0), (ta, tf) = start
    ref = ref_shrink.solve_shrunk(RefDense(c.K), c.y, mask, c.ds.C, a0, f0,
                                  **kw)
    port = shrink.solve_shrunk(DenseKernel(c.tK), c.ty, _t(mask), c.ds.C, ta,
                               tf, **kw)
    return mask, ref, port


def _cold(c):
    z = jnp.zeros(c.n)
    return (z, -c.y), (_t(z), -c.ty)


@pytest.mark.parametrize("name,method", [("heart", "cold"), ("adult", "cold"),
                                         ("adult", "sir")])
def test_solve_shrunk_bitwise_to_first_reconstruction(name, method,
                                                      request):
    c = request.getfixturevalue(name)
    start = _cold(c) if method == "cold" else c.seeded(method)
    fold = 0 if method == "cold" else 1
    mask = jnp.asarray(c.masks[fold])
    (a0, f0), (ta, tf) = start
    ref = _first_reconstruction(ref_shrink, RefDense(c.K), c.y, mask, c.ds.C,
                                a0, f0, **KW)
    port = _first_reconstruction(shrink, DenseKernel(c.tK), c.ty, _t(mask),
                                 c.ds.C, ta, tf, **KW)
    assert ref and port, "both solves reconstruct"
    assert np.array_equal(port["alpha"], ref["alpha"])
    assert np.abs(port["f"] - ref["f"]).max() <= 1e-12


@pytest.mark.parametrize("name,method", [("heart", "cold"), ("adult", "cold"),
                                         ("adult", "sir")])
def test_solve_shrunk_after_reconstruction(name, method, request):
    """The full-set contract after unshrinking: the reference's support
    vectors and iterations, its objective within 1e-6 relative, the gap
    within tol, f consistent with alpha within 1e-10."""
    c = request.getfixturevalue(name)
    start = _cold(c) if method == "cold" else c.seeded(method)
    mask, ref, port = _solve_both(c, 0 if method == "cold" else 1, start,
                                  **KW)
    tmask = _t(mask)
    assert bool(port.converged) and bool(ref.converged)
    assert int(port.n_iter) == int(ref.n_iter)
    assert torch.equal(port.alpha > 0, _t(ref.alpha > 0))
    assert float(port.b_low - port.b_up) <= 1e-3
    f_true = c.tK @ (port.alpha * c.ty) - c.ty
    assert float((port.f - f_true).abs().max()) <= 1e-10
    assert not bool((port.alpha[~tmask] != 0).any())
    obj = float(dual_objective(c.tK, c.ty, port.alpha))
    ref_obj = float(dual_objective(c.tK, c.ty, _t(ref.alpha)))
    assert abs(obj - ref_obj) <= 1e-6 * abs(ref_obj)


def test_solve_shrunk_witness_takes_reference_reconstruction(adult,
                                                             monkeypatch):
    """The only step that differs is f's reconstruction: given the
    reference's reconstructed f, the port's run is the reference's bit for
    bit (alpha, f, n_iter)."""
    c = adult
    mask = jnp.asarray(c.masks[0])
    src = RefDense(c.K)

    def ref_f(source, y, alpha):
        return _t(ref_shrink.reconstruct_f(src, c.y, jnp.asarray(
            alpha.numpy())))

    monkeypatch.setattr(shrink, "reconstruct_f", ref_f)
    (a0, f0), (ta, tf) = _cold(c)
    ref = ref_shrink.solve_shrunk(src, c.y, mask, c.ds.C, a0, f0, **KW)
    port = shrink.solve_shrunk(DenseKernel(c.tK), c.ty, _t(mask), c.ds.C,
                               ta, tf, **KW)
    assert int(port.n_iter) == int(ref.n_iter)
    assert torch.equal(port.alpha, _t(ref.alpha))
    assert torch.equal(port.f, _t(ref.f))


def test_shrink_every_zero_is_solve(heart):
    c = heart
    m = _t(c.masks[0])
    z = torch.zeros(c.n, dtype=torch.float64)
    a = shrink.solve_shrunk(DenseKernel(c.tK), c.ty, m, c.ds.C, z, -c.ty,
                            shrink_every=0, chunk_iters=100)
    b = solve(DenseKernel(c.tK), c.ty, m, c.ds.C, z, -c.ty, chunk_iters=100)
    for x, w in zip(a, b):
        assert torch.equal(x, w)


def test_iterates_identical_across_chunk_iters_and_quantum(adult):
    c = adult
    m = _t(c.masks[0])
    z = torch.zeros(c.n, dtype=torch.float64)
    runs = [shrink.solve_shrunk(DenseKernel(c.tK), c.ty, m, c.ds.C, z, -c.ty,
                                shrink_every=64, shrink_quantum=q,
                                chunk_iters=ci)
            for ci, q in ((64, 16), (32, 16), (1000, 16), (64, 8))]
    for r in runs[1:]:
        assert int(r.n_iter) == int(runs[0].n_iter)
        assert torch.equal(r.alpha, runs[0].alpha)
        assert torch.equal(r.f, runs[0].f)


def test_pallas_rbf_shrinks(adult):
    """A row-streaming source shrinks to a compact ``PallasRBF`` (X, its
    norms and ordered norms gathered, bitwise the tables of the compact X)
    and solves to the reference's ``PallasRBF`` fixed point (its dot
    products sum in another order, so not bitwise: the objective within
    1e-6 relative)."""
    c = adult
    mask = jnp.asarray(c.masks[0])
    kw = dict(KW, wss="1")
    (a0, f0), (ta, tf) = _cold(c)
    src = PallasRBF(c.tX, c.ds.gamma)
    idx = torch.tensor([3, 7, 150, c.n, c.n])
    comp = src.compact(idx)
    at = idx.clamp_max(c.n - 1)
    own = PallasRBF(c.tX[at], c.ds.gamma)
    assert type(comp) is PallasRBF
    for a, b in ((comp.X, own.X), (comp.sq_norms, own.sq_norms),
                 (comp.seq_norms, own.seq_norms), (comp.X_rows, own.X_rows)):
        assert torch.equal(a, b)
    ref = ref_shrink.solve_shrunk(RefPallas(c.X, c.ds.gamma), c.y, mask,
                                  c.ds.C, a0, f0, **kw)
    port = shrink.solve_shrunk(src, c.ty, _t(mask), c.ds.C, ta, tf, **kw)
    assert bool(port.converged) and bool(ref.converged)
    v, vr = port.alpha * c.ty, _t(ref.alpha) * c.ty
    obj = float(port.alpha.sum() - 0.5 * v @ src.matvec(v))
    ref_obj = float(_t(ref.alpha).sum() - 0.5 * vr @ src.matvec(vr))
    assert abs(obj - ref_obj) <= 1e-6 * abs(ref_obj)


def test_dense_compact_is_one_gather(heart):
    c = heart
    idx = torch.tensor([5, 2, 9, c.n, c.n])
    comp = DenseKernel(c.tK).compact(idx)
    at = idx.clamp_max(c.n - 1)
    assert torch.equal(comp.K, c.tK[at][:, at])
    assert torch.equal(DenseKernel(c.tK).matvec(c.ty), c.tK @ c.ty)


# --------------------------------------------- chunks over per-lane sources


@pytest.mark.parametrize("kind", ["dense", "pallas_rbf"])
def test_chunk_batched_sources_is_each_lanes_own_chunk(adult, kind):
    """Lanes with their own compact operands, stacked: each lane bitwise
    its own single-lane chunk over its own source (the plain version on
    the CPU; the card's per-lane kernels are held to it in
    test_torch_cuda.py), done lanes untouched."""
    c = adult
    wss = "1" if kind == "pallas_rbf" else "2"
    full = PallasRBF(c.tX, c.ds.gamma) if kind == "pallas_rbf" \
        else DenseKernel(c.tK)
    g = torch.Generator().manual_seed(0)
    idxs = [torch.sort(torch.randperm(c.n, generator=g)[:48]).values
            for _ in range(3)]
    srcs = [full.compact(i) for i in idxs]
    ys = torch.stack([c.ty[i] for i in idxs])
    masks = torch.stack([torch.rand(48, generator=g) > 0.2 for _ in idxs])
    states = EngineState(torch.zeros(3, 48, dtype=torch.float64), -ys,
                         torch.zeros(3, dtype=torch.int64),
                         torch.tensor([False, True, False]))
    Cs, caps = [1.0, 2.0, 0.5], [40, 40, 25]
    out = chunk_batched_sources(stack_sources(srcs), ys, masks, Cs, 1e-3,
                                caps, states, 30, wss)
    for l in range(3):
        one = smo_chunk(srcs[l], ys[l], masks[l], Cs[l], states.lane(l),
                        n_iters=30, wss=wss, tol=1e-3, it_cap=caps[l])
        for a, b in zip(out.lane(l), one):
            assert torch.equal(a, b)
    assert torch.equal(out.lane(1).alpha, states.lane(1).alpha)
    assert sum(ops.launch_counts().values()) == 0


# ----------------------------------------------------------- the pool


def _pool_lanes(c, width, **kw):
    pool = LanePool({"s": DenseKernel(c.tK)}, c.ty, max_width=width,
                    chunk_iters=64, shrink_every=64, shrink_quantum=16, **kw)
    z = torch.zeros(c.n, dtype=torch.float64)
    for h in range(3):
        pool.add(h, _t(c.masks[h]), c.ds.C * (1 + h), z, -c.ty)
    return pool


@pytest.mark.parametrize("width", [1, 2, 4])
def test_pool_shrink_is_solve_shrunk(adult, width):
    c = adult
    pool = _pool_lanes(c, width)
    out = pool.run()
    z = torch.zeros(c.n, dtype=torch.float64)
    for h in range(3):
        one = shrink.solve_shrunk(DenseKernel(c.tK), c.ty, _t(c.masks[h]),
                                  c.ds.C * (1 + h), z, -c.ty, **KW)
        for a, b in zip(out[h], one):
            assert torch.equal(a, b)
    occ = pool.occupancy
    assert occ["shrink_lane_chunks"] > 0
    assert 0 < occ["mean_active_frac"] < 1
    assert all(len(p) == 3 for p in pool._programs)
    if width > 1:   # compact groups ran together over their own operands
        assert any(w > 1 and cap < c.n for _, w, cap in pool._programs)


@pytest.mark.parametrize("kind", ["dense", "pallas_rbf"])
def test_pool_stacks_a_group_once_while_it_holds(adult, kind, monkeypatch):
    """A compact group's operands are stacked when its lanes or their
    compact sources change, not at every chunk, and pad lanes' slots are
    zeros, not copies of a lane's operands; the lanes stay bitwise their
    solo ``solve_shrunk``."""
    c = adult
    full = PallasRBF(c.tX, c.ds.gamma) if kind == "pallas_rbf" \
        else DenseKernel(c.tK)
    wss = "1" if kind == "pallas_rbf" else "2"
    stacks, dispatches = [], [0]
    real_stack, real_chunk = engine.stack_sources, engine.chunk_batched_sources
    from repro_torch.svm import scheduler

    def stack(srcs, width=None):
        stacks.append((len(srcs), real_stack(srcs, width)))
        return stacks[-1][1]

    def chunk(*a, **kw):
        dispatches[0] += 1
        return real_chunk(*a, **kw)
    monkeypatch.setattr(scheduler, "stack_sources", stack)
    monkeypatch.setattr(scheduler, "chunk_batched_sources", chunk)
    pool = LanePool({"s": full}, c.ty, max_width=4, lane_quantum=4,
                    chunk_iters=16, shrink_every=64, shrink_quantum=16,
                    wss=wss)
    z = torch.zeros(c.n, dtype=torch.float64)
    for h in range(3):
        pool.add(h, _t(c.masks[h]), c.ds.C, z, -c.ty)
    out = pool.run()
    assert 0 < len(stacks) < dispatches[0]
    for k, st in stacks:   # the pad lanes' slots
        ops_ = st.K if kind == "dense" else st.X
        assert not ops_[k:].any()
    assert any((st.K if kind == "dense" else st.X).shape[0] > k
               for k, st in stacks)
    for h in range(3):
        one = shrink.solve_shrunk(full, c.ty, _t(c.masks[h]), c.ds.C, z,
                                  -c.ty, wss=wss, chunk_iters=16,
                                  shrink_every=64, shrink_quantum=16)
        for a, b in zip(out[h], one):
            assert torch.equal(a, b)


@pytest.mark.parametrize("batched,backend,shrink_every", [
    (False, "dense", 0), (False, "dense", 64), (True, "pallas_rbf", 64)])
def test_finished_run_frees_its_pool_without_a_cyclic_collection(
        batched, backend, shrink_every):
    """A pool and its source cache hold no reference cycle: once
    ``run_cv`` / ``run_cv_batched`` returns, its pool, cache and kernels
    are gone by reference counting alone (with the cyclic collector off),
    so a caller's second run never holds the first one's K."""
    ds = make_dataset("adult", n_override=200)

    def alive():
        return sum(type(o) in (LanePool, SourceCache)
                   for o in gc.get_objects())
    gc.collect()
    before = alive()
    gc.disable()
    try:
        kw = dict(k=3, device="cpu", shrink_every=shrink_every,
                  shrink_quantum=16)
        if batched:
            run_cv_batched(ds, source_backend=backend, **kw)
        else:
            run_cv(ds, method="sir", **kw)
        assert alive() == before
    finally:
        gc.enable()


def test_pool_shrink_off_keeps_program_keys(adult):
    """``shrink_every=0``: (source, width) program keys, no shrink ledger
    and no shrink occupancy, as before shrinking was ported."""
    c = adult
    pool = LanePool({"s": DenseKernel(c.tK)}, c.ty, max_width=0,
                    chunk_iters=64)
    z = torch.zeros(c.n, dtype=torch.float64)
    for h in range(3):
        pool.add(h, _t(c.masks[h]), c.ds.C, z, -c.ty)
    pool.run()
    assert pool.shrink_every == 0
    assert pool._programs == {("s", 4), ("s", 2), ("s", 1)} or \
        all(len(p) == 2 for p in pool._programs)
    assert all(ln.shrink is None for ln in pool._lanes.values())
    assert "shrink_lane_chunks" not in pool.occupancy


def test_seeded_admission_starts_shrunk(adult):
    """A lane seeded through ``seed_fn`` enters its compact bucket at
    admission (the reference's ``seed_shrink``: its cap and mask)."""
    c = adult
    (a0, f0), (ta, tf) = c.seeded("sir")
    mask = jnp.asarray(c.masks[1])
    ref_ls = ref_shrink.LaneShrink(c.n, every=64, quantum=16)
    ref_state = ref_shrink.init_state(RefDense(c.K), c.y, mask, a0, f0)
    ref_shrink.seed_shrink(ref_ls, c.y, mask, c.ds.C, ref_state, tol=1e-3)
    pool = LanePool({"s": DenseKernel(c.tK)}, c.ty, max_width=0,
                    chunk_iters=64, shrink_every=64, shrink_quantum=16)
    z = torch.zeros(c.n, dtype=torch.float64)
    prev = solve(DenseKernel(c.tK), c.ty, _t(c.masks[0]), c.ds.C, z, -c.ty)
    pool.add_result("prev", prev)
    pool.add("seeded", _t(mask), c.ds.C, dep="prev",
             seed_fn=lambda r: (ta, tf))
    pool._admit()
    ls = pool._lanes["seeded"].shrink
    assert ref_ls.cap > 0 and ls.cap == ref_ls.cap and ls.m == ref_ls.m
    assert torch.equal(ls.active, _t(ref_ls.active))


# ----------------------------------------------------------- the drivers


@pytest.mark.parametrize("name,method", [("heart", "cold"), ("adult", "sir")])
def test_run_cv_shrink_reaches_reference_counts(name, method):
    ds = make_dataset(name, n_override=120 if name == "heart" else 200)
    kw = dict(k=3, method=method, shrink_every=64, shrink_quantum=16)
    ref = ref_run_cv(ds, **kw)
    port = run_cv(ds, device="cpu", **kw)
    assert [f.acc_correct for f in port.folds] == \
        [f.acc_correct for f in ref.folds]
    assert all(f.converged for f in port.folds)
    assert port.occupancy["shrink_lane_chunks"] > 0


@pytest.mark.parametrize("backend", ["dense", "pallas_rbf"])
def test_run_cv_batched_shrink_reaches_reference_counts(backend):
    ds = make_dataset("adult", n_override=200)
    kw = dict(k=3, shrink_every=64, shrink_quantum=16,
              source_backend=backend)
    ref = ref_run_cv_batched(ds, **kw)
    port = run_cv_batched(ds, device="cpu", max_width=0, **kw)
    assert [f.acc_correct for f in port.folds] == \
        [f.acc_correct for f in ref.folds]
    assert port.occupancy["shrink_lane_chunks"] > 0


def test_run_cv_batched_shrink_needs_repacked():
    ds = make_dataset("heart", n_override=60)
    with pytest.raises(ValueError, match="repacked"):
        run_cv_batched(ds, k=3, schedule="batched", shrink_every=64,
                       device="cpu")


def test_run_grid_shrink_reaches_reference_counts():
    ds = make_dataset("adult", n_override=150)
    kw = dict(k=3, method="sir", shrink_every=64, shrink_quantum=16)
    ref = ref_run_grid(ds, [0.5, 2.0], [ds.gamma], **kw)
    port = run_grid(ds, [0.5, 2.0], [ds.gamma], device="cpu", **kw)
    assert [cl.acc_correct for cl in port.cells] == \
        [cl.acc_correct for cl in ref.cells]
    assert port.occupancy["shrink_lane_chunks"] > 0


# ----------------------------------------------------------- the cost model


def test_pick_shrink_falls_back_and_reads_a_model(tmp_path):
    assert cost_model.fallback_shrink("cpu") is False
    assert cost_model.fallback_shrink("cuda") is True
    empty = {"entries": {}}
    assert cost_model.pick_shrink("cpu", model=empty) is False
    assert cost_model.pick_shrink("cuda", model=empty) is True
    assert cost_model.pick_shrink("cpu", path=tmp_path / "none.json") is False
    model = {"entries": {"cuda": {"dense": {"shrink": False},
                                  "pallas_rbf": {"shrink": True}}}}
    path = tmp_path / "model.json"
    path.write_text(json.dumps(model))
    assert cost_model.pick_shrink("cuda", kinds=("pallas_rbf",),
                                  path=path) is True
    assert cost_model.pick_shrink("cuda", kinds=("dense", "pallas_rbf"),
                                  path=path) is False
    for dev, kinds in (("cpu", ("dense",)), ("cpu", ("pallas_rbf",)),
                       ("cpu", ("dense", "pallas_rbf"))):
        assert cost_model.pick_shrink(dev, kinds=kinds) == \
            ref_cost_model.pick_shrink(dev, kinds=kinds)
