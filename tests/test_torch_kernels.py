"""The port's kernels against the JAX reference's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold those to the reference's Pallas kernels (run in interpret mode, as the
reference's own tests run them here) and to its jnp oracles, at the
reference's bars (``tests/test_kernels.py``). The CUDA kernels themselves
are held to the plain versions on the card (``test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbf import rbf_kernel_matrix as pallas_rbf
from repro.kernels.ref import fused_smo_step_ref as jnp_step_ref
from repro.kernels.ref import rbf_kernel_matrix_ref as jnp_rbf_ref
from repro.kernels.ref import smo_f_update_ref as jnp_fupdate_ref
from repro.kernels.smo_step import fused_smo_step as pallas_step
from repro.kernels.smo_update import smo_f_update as pallas_fupdate
from repro.svm.kernels import rbf_kernel as jnp_rbf_kernel
from repro_torch.kernels import ops, ref
from repro_torch.svm import kernel_matrix

RNG = np.random.default_rng(7)
#: the reference's bars: f32 atol 1e-5, f64 atol 1e-10
ATOL = {np.float32: 1e-5, np.float64: 1e-10}
TORCH = {np.float32: torch.float32, np.float64: torch.float64}


@pytest.mark.parametrize("n,m,d", [(64, 64, 16), (100, 130, 70), (257, 63, 9),
                                   (32, 512, 128)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rbf_plain_matches_reference(n, m, d, dtype):
    X = RNG.normal(size=(n, d)).astype(dtype)
    Z = RNG.normal(size=(m, d)).astype(dtype)
    out = ops.rbf_kernel_matrix(torch.from_numpy(X), torch.from_numpy(Z),
                                0.37).numpy()
    assert out.dtype == dtype and out.shape == (n, m)
    for want in (pallas_rbf(jnp.asarray(X), jnp.asarray(Z), 0.37, bm=64,
                            bn=64, bk=64),
                 jnp_rbf_ref(jnp.asarray(X), jnp.asarray(Z), 0.37),
                 jnp_rbf_kernel(jnp.asarray(X), jnp.asarray(Z), 0.37)):
        np.testing.assert_allclose(out, np.asarray(want), atol=ATOL[dtype])


@pytest.mark.parametrize("name,n", [("heart", 270), ("adult", 1000)])
def test_rbf_plain_main_path_shapes(name, n):
    """The K of the Table-1 configurations (f64, the main path)."""
    from repro.data.svm_suite import make_dataset
    X = make_dataset(name, n_override=n).X
    K = kernel_matrix(torch.from_numpy(X), torch.from_numpy(X), gamma=0.2)
    want = jnp_rbf_kernel(jnp.asarray(X), jnp.asarray(X), 0.2)
    np.testing.assert_allclose(K.numpy(), np.asarray(want), atol=1e-10)


@pytest.mark.parametrize("n", [100, 1000, 8192, 10_000])
def test_f_update_plain_bitwise(n):
    """torch.addcmul rounds f + delta*(K_i - K_j) as one FMA, exactly as
    XLA-CPU compiles the reference's Pallas body and its jnp oracle."""
    f, Ki, Kj = (RNG.normal(size=(n,)) for _ in range(3))
    out = ops.smo_f_update(*(torch.from_numpy(a) for a in (f, Ki, Kj)),
                           0.37).numpy()
    for want in (pallas_fupdate(f, Ki, Kj, 0.37, block=1024),
                 jax.jit(jnp_fupdate_ref)(f, Ki, Kj, 0.37)):
        np.testing.assert_array_equal(out, np.asarray(want))


@pytest.mark.parametrize("rows,n", [(1, 100), (3, 1000)])
def test_f_update_rows_plain_is_each_rows_f_update(rows, n):
    """Each row of smo_f_update over rows is smo_f_update of that row with
    its delta, bit for bit (one FMA an element)."""
    f, Ki, Kj = (torch.from_numpy(RNG.normal(size=(rows, n)))
                 for _ in range(3))
    d = torch.from_numpy(RNG.normal(size=rows))
    got = ops.smo_f_update(f, Ki, Kj, d)
    for r in range(rows):
        assert torch.equal(got[r], ops.smo_f_update(f[r], Ki[r], Kj[r], d[r]))


def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    X = torch.from_numpy(RNG.normal(size=(20, 5)))
    K = ops.rbf_kernel_matrix(X, X, 0.5)
    ops.smo_f_update(K[0], K[1], K[2], 0.1)
    n = K.shape[0]
    y = torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0).double()
    ops.smo_chunk(K, torch.diagonal(K).contiguous(), y,
                  torch.ones(n, dtype=torch.bool), 1.0, 1e-3, 100, 5, "2",
                  torch.zeros(n, dtype=torch.float64), -torch.ones(n).double(),
                  torch.tensor(0), torch.tensor(False))
    sq = torch.sum(X * X, -1)
    ops.fused_smo_step(-y, X, X[[0, 1]], sq, 0.1, 0.5)
    lanes = (torch.ones((2, n), dtype=torch.bool), [1.0, 1.0], 1e-3,
             [100, 100], 5, torch.zeros((2, n), dtype=torch.float64),
             -y.repeat(2, 1), torch.zeros(2, dtype=torch.int64),
             torch.zeros(2, dtype=torch.bool))
    ops.smo_chunk_lanes(K, torch.diagonal(K).contiguous(), y, *lanes[:4],
                        lanes[4], "2", *lanes[5:])
    ops.smo_stream_chunk(X, sq, 0.5, y, *lanes)
    ops.smo_select(X, sq, 0.5, y, *lanes[:4], *lanes[5:])
    two = lambda t: t.expand(2, *t.shape).clone()  # noqa: E731
    ops.smo_chunk_sources(two(K), two(torch.diagonal(K)), two(y),
                          *lanes[:4], lanes[4], "2", *lanes[5:])
    ops.smo_stream_chunk_sources(two(X), two(sq), 0.5, two(y), *lanes)
    q = torch.from_numpy(RNG.normal(size=(1, 4, 9, 16)))
    ops.flash_attention(q, q[:, :2], q[:, :2], window=3)
    lo, hi = torch.zeros(n, dtype=torch.float64), torch.ones(n).double()
    ops.water_fill(y, lo, hi, 0.5)
    ops.sir_greedy(K[:3], y[:3], y, torch.ones(3).double(),
                   torch.rand(n).double())
    on = torch.ones(n, dtype=torch.bool)
    Cs = torch.ones(2, dtype=torch.float64)
    s2 = ops.ato_system_lanes(K, y, Cs, two(lo), two(-y), Cs * 0, on, ~on,
                              two(~on), two(~on), 4)
    ops.ato_apply_lanes(two(K[0]), two(-y), two(lo), s2.v, two(lo), y, s2.b,
                        Cs, 1e-3, s2.train_now, s2.free, two(~on), two(~on),
                        torch.zeros(2, dtype=torch.bool),
                        torch.zeros(2, dtype=torch.int64), 30)
    ops.smo_f_update(two(y), two(lo), two(hi), Cs)
    ops.avg_spill(y, lo - 1, hi, on, torch.tensor(0.5, dtype=torch.float64))
    ops.top_spill(torch.arange(n), y, lo - 1, hi,
                  torch.tensor(0.5, dtype=torch.float64))
    ops.avg_spill_loo(y, hi * 0.5, 1.0, 0)
    ops.top_spill_loo(K, y, hi * 0.5, 1.0, n - 1)
    u = torch.from_numpy(RNG.normal(size=(2, 5, 8))).float()
    ops.selective_scan(u, u.abs(), -torch.ones(8, 16), u[..., :1].repeat(
        1, 1, 16), u[..., 1:2].repeat(1, 1, 16), h_out=torch.empty(2, 8, 16))
    q = torch.from_numpy(RNG.normal(size=(2, 5, 2, 8))).float()
    ops.mlstm_parallel(q, q, q, q[..., 0], -q[..., 0].abs())
    g = u.repeat(1, 1, 4).split(8, dim=-1)
    ops.slstm_scan(*g, torch.eye(8), torch.ones(8))
    assert ops.launch_counts() == {"rbf_kernel_matrix": 0,
                                   "smo_f_update": 0, "smo_chunk": 0,
                                   "smo_chunk_sources": 0,
                                   "fused_smo_step": 0, "smo_select": 0,
                                   "smo_stream_chunk": 0,
                                   "smo_stream_chunk_sources": 0,
                                   "flash_attention": 0, "water_fill": 0,
                                   "sir_greedy": 0, "ato_system_lanes": 0,
                                   "ato_apply_lanes": 0, "avg_spill": 0,
                                   "top_spill": 0, "selective_scan": 0,
                                   "mlstm_parallel": 0, "slstm_scan": 0}
    assert ops.route_counts()["avg_spill"] == {"fused": 0, "split": 0}
    assert ops.route_counts()["top_spill"] == {"fused": 0, "split": 0}


def _loo_case(n, t, seed, C=2.5):
    """(y, alpha, C, t): labels +-1, alpha at 0 (beta -0.0 where y = -1),
    at C and inside the box."""
    rng = np.random.default_rng(seed)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    u = rng.random(n)
    alpha = torch.from_numpy(np.where(u < 0.3, 0.0, np.where(
        u < 0.5, C, rng.random(n) * C)))
    return y, alpha, C, t


def _glue(y, C, alpha, t):
    """The LOO seeders' prologue as the seeders wrote it before the fused
    routes (``_loo_start`` and the free0 lines)."""
    beta = y * alpha
    resid = beta[t].clone()
    beta.select(0, t).fill_(0.0)
    c = torch.full_like(y, C)
    hi = torch.where(y > 0, c, 0.0)
    lo = hi - c
    lo.select(0, t).fill_(0.0)
    hi.select(0, t).fill_(0.0)
    free0 = (alpha > 0) & (alpha < C)
    free0.select(0, t).fill_(False)
    return beta, resid, lo, hi, free0


def _same_bits(a, b):
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    return torch.equal(a, b)


LOO_CASES = [(27, 0, 1), (27, 26, 2), (270, 9, 3), (270, 269, 4),
             (1000, 499, 5), (1000, 0, 6)]


@pytest.mark.parametrize("n,t,seed", LOO_CASES)
def test_loo_start_plain_is_the_seeders_glue(n, t, seed):
    """The fused spills' prologue from (y, alpha, C, t), bitwise the
    seeders' earlier glue: beta (its -0.0 too), resid, lo, hi, free0."""
    y, alpha, C, t = _loo_case(n, t, seed)
    got = ref.loo_start_ref(y, alpha, C, t)
    want = _glue(y, C, alpha, t)
    assert all(_same_bits(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("n,t,seed", LOO_CASES)
def test_spill_loo_plain_is_the_seeders_glue(n, t, seed):
    """avg_spill_loo / top_spill_loo on the CPU: the glue, then the spill's
    plain version (and TOP's stable argsort), bit for bit."""
    y, alpha, C, t = _loo_case(n, t, seed)
    K = torch.from_numpy(np.random.default_rng(seed).random((n, n)))
    beta, resid, lo, hi, free0 = _glue(y, C, alpha, t)
    got = ops.avg_spill_loo(y, alpha, C, t)
    want = ref.avg_spill_ref(beta, lo, hi, free0, resid)
    assert all(_same_bits(a, b) for a, b in zip(got, (want, lo, hi)))
    sim = K[:, t].clone()
    sim.select(0, t).fill_(-math.inf)
    order = torch.argsort(-sim, stable=True)
    got = ops.top_spill_loo(K, y, alpha, C, t)
    want = ref.top_spill_ref(order, beta, lo, hi, resid)
    assert all(_same_bits(a, b) for a, b in zip(got, (want, lo, hi)))


def _avg_spill_counted(beta, lo, hi, free0, resid):
    """avg_spill's fused route in plain torch: each of the 8 rounds takes
    its count of free rows with room from the round before, which counts
    both sides (above: hi - beta > 1e-15, below: beta - lo > 1e-15) on the
    beta it leaves (round 0's from the entry), and picks the side of its
    residual."""
    resid = torch.as_tensor(resid, dtype=beta.dtype, device=beta.device)

    def counts(b):
        return ((free0 & (hi - b > 1e-15)).sum(),
                (free0 & (b - lo > 1e-15)).sum())
    up, down = counts(beta)
    for _ in range(8):
        share = resid / torch.clamp_min(torch.where(resid >= 0, up, down), 1)
        room = torch.where(resid >= 0, hi - beta, beta - lo)
        add = torch.clamp(torch.where(free0 & (room > 1e-15), share, 0.0),
                          -(beta - lo), hi - beta)
        beta = beta + add
        up, down = counts(beta)
        resid = resid - add.sum()
    return beta


def _loo_order_lists(sim, t: int, threads: int):
    """top_spill's fused route's order in plain torch: the rows in lists
    by warp (row j in list (j % threads) // 32), each list in
    ``loo_order_ref``'s order, and the order taken 32 rows at a time, the
    least of every list's next 32 (ties by the lower index), each list's
    head moving on by its rows among them."""
    n = sim.shape[0]
    v = -sim.clone()
    v.select(0, t).fill_(math.inf)
    rows = torch.arange(n, device=sim.device)
    owner = (rows % threads) // 32
    lists = [rows[owner == w] for w in range((threads + 31) // 32)]
    lists = [r[torch.argsort(v[r], stable=True)] for r in lists]
    heads, out = [0] * len(lists), []
    while sum(heads) < n:
        cand = torch.cat([r[h:h + 32] for r, h in zip(lists, heads)])
        cand = cand.sort().values
        take = cand[torch.argsort(v[cand], stable=True)][:32]
        out.append(take)
        for w in range(len(lists)):
            heads[w] += int((owner[take] == w).sum())
    return torch.cat(out)


@pytest.mark.parametrize("n,t,seed", LOO_CASES)
@pytest.mark.parametrize("side", [1.0, -1.0])
def test_avg_spill_counted_model_bitwise(n, t, seed, side):
    """The fused AVG route's schedule (each round's count from the round
    before, both sides counted) is the spill's plain version bit for bit,
    with the residual of either sign."""
    y, alpha, C, t = _loo_case(n, t, seed)
    y[t], alpha[t] = side, 0.7 * C
    beta, resid, lo, hi, free0 = ref.loo_start_ref(y, alpha, C, t)
    assert _same_bits(_avg_spill_counted(beta, lo, hi, free0, resid),
                      ref.avg_spill_ref(beta, lo, hi, free0, resid))


def test_top_fused_max_rows_is_the_kernels():
    """The wrapper's size limit for TOP's fused route is the kernel's own
    (``kTopMaxRows`` in ``csrc/seeding.cu``), so the route by size never
    hands the C entry a size it refuses."""
    from pathlib import Path

    from repro_torch.kernels import seeding as ks
    src = (Path(ks.__file__).parent / "csrc" / "seeding.cu").read_text()
    assert (f"constexpr int kTopMaxRows = {ks.TOP_FUSED_MAX_ROWS};"
            in src)


@pytest.mark.parametrize("n,threads", [(27, 32), (270, 256), (1000, 256),
                                       (3000, 1024)])
def test_loo_order_lists_model(n, threads):
    """The fused TOP route's order (per-warp sorted lists, 32 rows merged
    at a time) is the stable argsort's, entry for entry: ties, -0.0 beside
    +0.0, NaN (after row t) and row t itself."""
    rng = np.random.default_rng(n)
    sim = torch.from_numpy(rng.random(n))
    sim[1::4] = sim[0]
    sim[2::7] = 0.0
    sim[3::7] = -0.0
    sim[n // 2] = math.nan
    t = n // 3
    assert torch.equal(_loo_order_lists(sim, t, threads),
                       ref.loo_order_ref(sim, t))


def test_arg_reduces_nan_guard():
    """The reference's NaN-guarded first-index reduces
    (``test_engine.py::test_arg_reduces_nan_guard``)."""
    nan, inf = float("nan"), float("inf")
    T = lambda v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    assert int(ref._argmin(T([3.0, nan, 1.0, nan]))) == 1
    assert int(ref._argmax(T([3.0, nan, 1.0, nan]))) == 1
    assert int(ref._argmin(T([3.0, 1.0, 1.0, 7.0]))) == 1
    assert int(ref._argmax(T([3.0, 7.0, 1.0, 7.0]))) == 1
    assert int(ref._argmin(T([nan, nan]))) == 0
    assert int(ref._argmin(T([inf, inf, inf]))) == 0
    assert int(ref._argmax(T([-inf, -inf, -inf]))) == 0


def _step_problem(n, d, dtype):
    """The reference's ``fused_smo_step`` test problem
    (``tests/test_kernels.py::_step_problem``), as numpy."""
    X = RNG.normal(size=(n, d)).astype(dtype)
    xij = X[[3, n - 1]]
    f = RNG.normal(size=(n,)).astype(dtype)
    return f, X, xij, np.sum(X * X, axis=1), dtype(0.37)


@pytest.mark.parametrize("n,d,bm,bk", [(257, 9, 64, 64), (100, 130, 64, 64),
                                       (120, 40, 32, 16), (150, 13, None,
                                                           None)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_fused_smo_step_plain_matches_reference(n, d, bm, bk, dtype):
    """The port's plain version against the reference's Pallas kernel in
    interpret mode (ragged blocks, and full blocks where bm = bk = None) and
    its jnp oracle, at the reference's bars: f64 atol 1e-12, f32 1e-5."""
    f, X, xij, sq, delta = _step_problem(n, d, dtype)
    out = ops.fused_smo_step(*(torch.from_numpy(a) for a in (f, X, xij, sq)),
                             float(delta), 0.5).numpy()
    assert out.dtype == dtype and out.shape == (n,)
    tol = 1e-12 if dtype == np.float64 else 1e-5
    for want in (pallas_step(jnp.asarray(f), jnp.asarray(X),
                             jnp.asarray(xij), jnp.asarray(sq),
                             jnp.asarray(delta), gamma=0.5, bm=bm, bk=bk),
                 jnp_step_ref(jnp.asarray(f), jnp.asarray(X),
                              jnp.asarray(xij), jnp.asarray(sq),
                              jnp.asarray(delta), 0.5)):
        np.testing.assert_allclose(out, np.asarray(want), atol=tol, rtol=0)


def test_fused_smo_step_plain_lanes():
    """Lanes: each is the one-lane result; a done lane keeps its f."""
    n, d, b = 120, 40, 3
    X = torch.from_numpy(RNG.normal(size=(n, d)))
    sq = torch.sum(X * X, -1)
    xij = X[torch.tensor([[3, 7], [0, 0], [119, 5]])]
    f = torch.from_numpy(RNG.normal(size=(b, n)))
    delta = torch.tensor([0.1, 0.2, 0.3], dtype=torch.float64)
    done = torch.tensor([False, False, True])
    got = ops.fused_smo_step(f, X, xij, sq, delta, 0.5, done=done)
    for l in range(2):
        assert torch.equal(got[l], ops.fused_smo_step(f[l], X, xij[l], sq,
                                                      delta[l], 0.5))
    assert torch.equal(got[2], f[2])


def test_kij_is_the_rows2_expression():
    """``rbf_kij_ref`` equals the one-pass rows expression at row j, and
    K[i, i] = 1 up to the clamp."""
    from repro.svm import FusedRBF as ref_fused
    X = RNG.normal(size=(90, 13))
    sq = np.sum(X * X, 1)
    src = ref_fused(jnp.asarray(X), 0.3)
    for i, j in [(0, 7), (31, 89), (40, 40)]:
        got = float(ref.rbf_kij_ref(torch.from_numpy(X), torch.from_numpy(sq),
                                    0.3, i, j))
        want = float(np.asarray(src.rows2(i, j)[0])[j])
        assert abs(got - want) <= 1e-12


def test_select_then_fused_step_is_one_streaming_step():
    """``smo_select`` followed by ``fused_smo_step`` over its pair rows and
    delta is the plain streaming step, lane by lane; a lane that arrives
    done, or freezes at its cap, is left as it was."""
    from repro.data.svm_suite import make_dataset
    ds = make_dataset("heart", n_override=90)
    X = torch.from_numpy(ds.X)
    y = torch.from_numpy(ds.y.astype(np.float64))
    sq = torch.sum(X * X, -1)
    n, b = 90, 4
    masks = torch.ones((b, n), dtype=torch.bool)
    for l in range(b):
        masks[l, l * 20:(l + 1) * 20] = False
    alphas = torch.zeros((b, n), dtype=torch.float64)
    fs = -y.repeat(b, 1)
    n_iter = torch.tensor([0, 5, 0, 3])
    done = torch.tensor([False, False, True, False])
    caps = [100, 100, 100, 3]
    a, it, dn, xij, delta = ops.smo_select(X, sq, ds.gamma, y, masks,
                                           [ds.C] * b, 1e-3, caps, alphas,
                                           fs, n_iter, done)
    f = ops.fused_smo_step(fs, X, xij, sq, delta, ds.gamma, done=dn)
    assert it.tolist() == [1, 6, 0, 3] and dn.tolist() == [False, False,
                                                         True, True]
    for l in (0, 1):
        want = ref.smo_step_ref(None, torch.ones(n, dtype=torch.float64), y,
                                masks[l], ds.C, 1e-3, caps[l], "1",
                                alphas[l], fs[l], int(n_iter[l]),
                                stream=(X, sq, ds.gamma))
        assert torch.equal(a[l], want[0]) and torch.equal(f[l], want[1])
    for l in (2, 3):
        assert torch.equal(a[l], alphas[l]) and torch.equal(f[l], fs[l])


# ---- the persistent streaming chunk's selection across blocks ----

def _better(va, ia, vb, ib, want_max):
    """The kernels' (value, index) rule (``smo_common.cuh``
    ``better_min`` / ``better_max``): NaN wins, then the smaller (larger)
    value, then the lower index."""
    na, nb = va != va, vb != vb
    if na != nb:
        return na
    if not na and va != vb:
        return va > vb if want_max else va < vb
    return ia < ib


def _two_level_select(alpha, f, y, mask, C, tiles, rng, cluster=1):
    """The one-launch streaming chunks' selection, modelled: every block
    (a slice of rows, cut as the plans cut them) takes its candidates for
    b_up / i and b_low / j and the OR of its set flags, visiting its rows
    in any order; with ``cluster`` > 1 (the cluster route) each cluster of
    that many consecutive blocks reduces its blocks' candidates in any
    order into one record; every block then reduces all records (the
    blocks', or the clusters') in any order by the same rule. Returns (i,
    j, gap)."""
    n = f.shape[0]
    slice_ = -(-n // tiles)
    i_up, i_low = ref._sets(alpha, y, mask, C)
    up, low, fv = i_up.tolist(), i_low.tolist(), f.tolist()
    none = (math.inf, 2 ** 31 - 1, -math.inf, 2 ** 31 - 1, 0)

    def merge(records):
        vu, iu, vl, il, fl = none
        for p in rng.permutation(len(records)).tolist():
            cu, ju, cl, jl, cf = records[p]
            if _better(cu, ju, vu, iu, False):
                vu, iu = cu, ju
            if _better(cl, jl, vl, il, True):
                vl, il = cl, jl
            fl |= cf
        return vu, iu, vl, il, fl

    cands = []
    for lo in range(0, n, slice_):
        cands.append(merge([
            (fv[k] if up[k] else math.inf, k, fv[k] if low[k] else -math.inf,
             k, (1 if up[k] else 0) | (2 if low[k] else 0))
            for k in range(lo, min(n, lo + slice_))]))
    assert len(cands) == tiles and tiles % cluster == 0
    records = [merge(cands[c:c + cluster]) for c in range(0, tiles, cluster)]
    vu, iu, vl, il, fl = merge(records)
    return iu, il, (vl - vu if fl == 3 else -math.inf)


def _check_selection(tiles, case, cluster=1):
    """``_two_level_select`` at ``tiles`` blocks in clusters of
    ``cluster`` against ``smo_select_ref`` on one of the cases below."""
    rng = np.random.default_rng(tiles if cluster == 1 else (tiles, cluster))
    n = 264 * 4   # 264, 132, 24, 8, 3 and 1 blocks under the plans' cut
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    C = 2.0
    alpha = torch.from_numpy(rng.choice([0.0, 0.7, C], size=n))
    f = torch.from_numpy(np.round(rng.normal(size=n), 1))
    mask = torch.from_numpy(rng.random(n) < 0.9)
    slice_ = -(-n // tiles)
    edges = sorted({min(n - 1, e) for lo in range(0, n, slice_)
                    for e in (lo, lo + slice_ - 1)})
    if case == "nan_at_edges":
        nan_rows = edges[len(edges) // 2:]
        mask[nan_rows] = True
        alpha[nan_rows] = 0.7   # free: in both sets
        f[nan_rows] = math.nan
    elif case == "nan_off_set":
        alpha[:] = 0.7
        mask[edges] = False
        f[edges] = math.nan
    elif case == "bound":
        alpha[:] = torch.where(y > 0, C, 0.0)
        alpha[edges[0]] = 0.7
    i, j, gap = _two_level_select(alpha, f, y, mask, C, tiles, rng, cluster)
    i_up, i_low = ref._sets(alpha, y, mask, C)
    v_up = torch.where(i_up, f, math.inf)
    v_low = torch.where(i_low, f, -math.inf)
    # the pair, stopping or not: NaN first, then the first extreme
    assert (i, j) == (int(ref._argmin(v_up)), int(ref._argmax(v_low)))
    want_gap = (float(v_low.max()) - float(v_up.min())
                if bool(i_up.any()) and bool(i_low.any()) else -math.inf)
    assert gap == want_gap or (math.isnan(gap) and math.isnan(want_gap))
    _, wi, wj, _, stop = ref.smo_select_ref(
        None, torch.ones(n, dtype=torch.float64), y, mask, C, 1e-3, 10 ** 6,
        "1", alpha, f, 0, (torch.ones((n, 1), dtype=torch.float64),
                           torch.ones(n, dtype=torch.float64), 0.5))
    assert stop == (gap <= 1e-3 or math.isnan(gap))
    if not stop:
        assert (i, j) == (wi, wj)
    if case == "nan_at_edges":
        assert math.isnan(gap) and i == j == nan_rows[0]


SELECT_CASES = ["ties", "nan_at_edges", "nan_off_set", "bound"]


@pytest.mark.parametrize("tiles", [1, 3, 264])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_two_level_selection_is_select_ref(tiles, case):
    """Per-block candidates reduced across blocks (the persistent
    chunk's one exchange an iteration) give ``smo_select_ref``'s pair and
    gap: the rule is exact in any order and at any cut into blocks. Ties
    (f on a coarse grid, so many rows share the extreme), NaN f on rows at
    block edges (the first NaN row must win), NaN f on rows outside both
    sets (it must not), and lanes pinned at the box."""
    _check_selection(tiles, case)


@pytest.mark.parametrize("tiles,cluster", [(8, 2), (24, 3), (132, 4),
                                           (264, 8)])
@pytest.mark.parametrize("case", SELECT_CASES)
def test_three_level_selection_is_select_ref(tiles, cluster, case):
    """The cluster route's exchange: blocks, then clusters (one record a
    cluster, through distributed shared memory), then the grid, each in
    any order, give ``smo_select_ref``'s pair and gap on the same cases
    at several cluster sizes, NaN rows at block and so at cluster edges."""
    _check_selection(tiles, case, cluster)


# ---- the routes of the redesigned kernels, and the wrappers' checks ----

@pytest.mark.parametrize("D", [16, 32, 64, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_route(dtype, D):
    """float32 runs on FMA; bf16 on wgmma from the 64-column panel up,
    on mma.sync below it."""
    from repro_torch.kernels.flash_attention import route
    want = ("fma" if dtype == torch.float32
            else "wgmma" if D >= 64 else "mma")
    assert route(dtype, D) == want


@pytest.mark.parametrize("dh", [64, 384])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_mlstm_route(dtype, dh):
    """float32 runs on FMA; bf16 on wgmma at xlstm-125m's dh = 384, the
    width it is built for, and on mma.sync at SMOKE's 64."""
    from repro_torch.kernels.mlstm import WGMMA_HEAD_DIM, route
    want = ("fma" if dtype == torch.float32
            else "wgmma" if dh == WGMMA_HEAD_DIM else "mma")
    assert route(dtype, dh) == want
    assert WGMMA_HEAD_DIM == 384


def test_mlstm_forced_route_on_cpu_tensors_is_the_plain_version():
    """On CPU tensors ``_route`` changes nothing: the plain version runs,
    bitwise, and no route counts a launch."""
    ops.reset_launch_counts()
    q = torch.from_numpy(RNG.normal(size=(1, 7, 2, 64))).to(torch.bfloat16)
    li = torch.from_numpy(RNG.normal(size=(1, 7, 2))).float() * 0.1
    lf = -li.abs()
    want = ops.mlstm_parallel(q, q, q, li, lf)
    for r in ("wgmma", "mma", "fma"):
        assert torch.equal(ops.mlstm_parallel(q, q, q, li, lf, _route=r),
                           want)
    assert ops.route_counts()["mlstm_parallel"] == {"wgmma": 0, "mma": 0,
                                                    "fma": 0}


def test_rbf_same_operand():
    """Z is X for the RBF kernel (its tensor route then computes half the
    tiles): one tensor passed twice, or two equal slices of one (the SVM
    paths' ``X[:n], X[:n]``); never a copy, another slice, a transpose or
    another dtype."""
    from repro_torch.kernels.rbf import same_operand
    X = torch.from_numpy(RNG.normal(size=(30, 6)))
    assert same_operand(X, X) and same_operand(X[:20], X[:20])
    assert not same_operand(X, X.clone())
    assert not same_operand(X[:20], X[1:21])
    assert not same_operand(X[:20], X[:21])
    assert not same_operand(X[:6], X[:6].T)
    assert not same_operand(X, X.float())


@pytest.mark.parametrize("n,sym,want", [(270, True, 32), (1000, True, 32),
                                        (4099, True, 128), (8192, True, 128),
                                        (32560, True, 128), (270, False, 32),
                                        (4099, False, 128), (2000, True, 64),
                                        (1000, False, 64), (2000, False, 128)])
def test_rbf_tensor_tile(n, sym, want):
    """The tensor route's tile on an H100 (132 SMs): the largest edge that
    gives every SM one and a half tiles (K(X, X) counts the tiles on and
    above the diagonal only), else the smallest: Table 1's K at tile 32,
    distinct operands of 1,000 rows at 64, the paper's n = 32,560 at 128."""
    from repro_torch.kernels.rbf import TENSOR_TILES, tensor_tile, tensor_tiles
    assert tensor_tile(n, n, sym, H100_SMS) == want
    assert tensor_tiles(4099, 4099, True, 128) == 33 * 34 // 2
    assert tensor_tiles(4099, 7, False, 64) == 65
    assert tensor_tile(10, 10 ** 6, False, H100_SMS) == TENSOR_TILES[0]


#: clusters an H100 (132 SMs) runs at once for each (blocks a cluster, rows
#: a thread) of the cluster kernel's builds, as ``cluster_capacity`` read
#: them on an NVIDIA H100 80GB HBM3 (chip_smoke.py prints them: its
#: ``smo_chunk_cluster_capacity``; n = 270 reads as 1,000, 32,560 as
#: 32,544)
H100_SMS = 132
H100_CLUSTERS = {
    1000: {(2, 4): 528, (2, 8): 528, (2, 16): 528, (2, 32): 462,
           (3, 4): 327, (3, 8): 327, (3, 16): 327, (3, 32): 287,
           (4, 4): 248, (4, 8): 248, (4, 16): 248, (4, 32): 216,
           (5, 4): 193, (5, 8): 193, (5, 16): 193, (5, 32): 171,
           (6, 4): 163, (6, 8): 163, (6, 16): 163, (6, 32): 141,
           (7, 4): 139, (7, 8): 139, (7, 16): 139, (7, 32): 124,
           (8, 4): 124, (8, 8): 124, (8, 16): 124, (8, 32): 107},
    4608: {(2, 8): 66, (2, 16): 132, (2, 32): 132, (3, 8): 79, (3, 16): 163,
           (3, 32): 163, (4, 8): 92, (4, 16): 124, (4, 32): 124, (5, 8): 94,
           (5, 16): 146, (5, 32): 171, (6, 8): 101, (6, 16): 124,
           (6, 32): 141, (7, 8): 84, (7, 16): 101, (7, 32): 124, (8, 8): 77,
           (8, 16): 92, (8, 32): 107},
    8192: {(2, 8): 66, (2, 16): 66, (2, 32): 132, (3, 16): 79, (3, 32): 79,
           (4, 8): 62, (4, 16): 92, (4, 32): 124, (5, 16): 69, (5, 32): 94,
           (6, 16): 79, (6, 32): 79, (7, 16): 69, (7, 32): 69, (8, 8): 62,
           (8, 16): 92, (8, 32): 107},
    32544: {(4, 32): 30, (8, 32): 30},
}
H100_CLUSTERS[270] = H100_CLUSTERS[1000]
H100_CLUSTERS[32560] = H100_CLUSTERS[32544]


def _h100_cluster(n, lanes):
    """The cluster plan an H100 gives ``lanes`` lanes of n rows (None where
    no shape places them)."""
    from repro_torch.kernels.smo_chunk import cluster_plan
    return cluster_plan(n, lanes, H100_CLUSTERS[n], H100_SMS)


@pytest.mark.parametrize("n,lanes,m,cluster,want", [
    (270, 1, 2, False, "one_block"), (1000, 1, 4, False, "one_block"),
    (2000, 1, 8, False, "one_block"), (4096, 1, 16, False, "one_block"),
    (4608, 1, 18, False, "one_block"), (4608, 132, 5, False, "one_block"),
    (4608, 133, 0, False, "one_block"), (6144, 1, 24, False, "multi_block"),
    (8192, 1, 32, False, "multi_block"), (8192, 88, 6, False, "multi_block"),
    (8192, 89, 0, True, "cluster"),
    (16384, 1, 64, False, "multi_block"),
    (32560, 1, 128, False, "multi_block"),
    (32560, 22, 24, False, "multi_block"), (32560, 23, 0, True, "cluster"),
    (270, 1, 2, True, "one_block"), (270, 10, 2, True, "one_block"),
    (1000, 1, 4, True, "one_block"), (1000, 10, 4, True, "one_block"),
    (32560, 1, 128, True, "multi_block"), (32560, 4, 128, True, "multi_block"),
    (32560, 16, 41, True, "cluster"), (32560, 22, 24, True, "cluster"),
    (32544, 24, 0, True, "cluster"), (32544, 32, 0, True, "one_block_global"),
    (8192, 88, 6, True, "cluster"), (4608, 1, 18, True, "cluster"),
    (4608, 132, 5, True, "one_block"), (4608, 133, 0, True, "cluster"),
])
def test_chunk_route(n, lanes, m, cluster, want):
    """The fastest route at the card's measured points (chip_smoke.py's
    crossover and lane sweeps), for ``lanes`` lanes of n rows given the m
    blocks a lane of the multi-block plan and (``cluster``) the cluster
    plan an H100 makes for them: heart (270) and adult n=1000 stay one
    block a lane on the resident kernel, one lane or Table 1's batched
    ten, whatever the other plans; at 4,608 rows the cluster route beats
    it, up to the 132 lanes that load each SM with a lane's rows at 16
    rows a thread (and past 132 lanes the one-block kernel runs in two
    waves);
    without a cluster plan, larger lanes spread over the m blocks
    the multi-block plan gives them (one lane of 32,560 rows: the size
    phase); a wide batch, which loads that route's SMs with large slices
    or leaves it none (m = 0: the lanes' state is more than the card's
    shared memory), takes the cluster route where its plan places the
    lanes (24 folds at n = 32,544; 88 lanes of 8,192 rows; 16 or more at
    32,560), and keeps one block a lane on the global-state kernel where
    no route places them on chip (32 lanes at n = 32,544)."""
    from repro_torch.kernels.smo_chunk import chunk_route
    plan = _h100_cluster(n, lanes) if cluster else None
    assert chunk_route(n, lanes, m, plan, H100_SMS) == want


def test_cluster_plan_is_pure():
    """The cluster plan is a function of (n, lanes, capacity, SMs) alone:
    no card, the same answer for equal inputs; at 24 lanes of 32,544 rows
    an H100 holds it as 4-block clusters at 32 rows a thread (256-thread
    blocks, one a SM: 8,192 rows an SM, as 8-block clusters of two
    128-thread blocks a SM would carry), and past the 30 clusters it runs
    at once there is no plan."""
    from repro_torch.kernels.smo_chunk import ClusterPlan, cluster_plan
    cap = H100_CLUSTERS[32544]
    got = cluster_plan(32544, 24, cap, H100_SMS)
    assert got == cluster_plan(32544, 24, dict(reversed(cap.items())),
                               H100_SMS)
    assert got == ClusterPlan(blocks=4, rows=32, threads=256, load=8192)
    assert cluster_plan(32544, 30, cap, H100_SMS) is not None
    assert cluster_plan(32544, 31, cap, H100_SMS) is None
    assert cluster_plan(32544, 1, {}, H100_SMS) is None


#: the cluster streaming route's capacity on an H100: clusters of C blocks
#: (2..8) the card runs at once at either tile, each block with the
#: kernel's whole shared memory (one block an SM), recorded from the card
#: (``stream_cluster_capacity``, chip_smoke.py's stream_routes phase); the
#: same at every d and lane count tried
H100_STREAM_CLUSTERS = {(c, rb): k for c, k in ((2, 66), (3, 39), (4, 30),
                                                 (5, 22), (6, 17), (7, 15),
                                                 (8, 15)) for rb in (2, 4)}

#: chip_smoke.py's streaming route sweep on an H100 (700 W): rows, d,
#: lanes, the persistent plan's blocks, and each placed route's us an
#: iteration (200 capped iterations, each route its best of 5 rounds)
STREAM_SWEEP_H100 = [
    (270, 123, 1, 3, {"cluster": 16.22, "persistent": 16.57, "pair": 23.54}),
    (270, 123, 4, 3, {"cluster": 16.47, "persistent": 16.97, "pair": 24.33}),
    (270, 123, 10, 3, {"cluster": 20.22, "persistent": 22.08,
                       "pair": 28.82}),
    (270, 123, 16, 3, {"cluster": 26.49, "persistent": 25.37,
                       "pair": 32.14}),
    (270, 123, 17, 0, {"pair": 29.11}),
    (1000, 123, 1, 8, {"cluster": 14.72, "persistent": 15.55, "pair": 22.69}),
    (1000, 123, 4, 8, {"cluster": 15.74, "persistent": 16.01, "pair": 23.58}),
    (1000, 123, 10, 8, {"cluster": 19.38, "persistent": 20.57,
                        "pair": 27.56}),
    (1000, 123, 16, 8, {"cluster": 24.65, "persistent": 23.96,
                        "pair": 30.61}),
    (1000, 123, 17, 0, {"pair": 27.2}),
    (4096, 123, 1, 32, {"cluster": 14.93, "persistent": 15.75,
                        "pair": 24.24}),
    (4096, 123, 4, 32, {"cluster": 15.28, "persistent": 16.28,
                        "pair": 24.77}),
    (4096, 123, 10, 32, {"cluster": 19.81, "persistent": 21.51,
                         "pair": 29.42}),
    (4096, 123, 16, 32, {"cluster": 25.39, "persistent": 24.81,
                         "pair": 33.54}),
    (4096, 123, 17, 0, {"pair": 29.79}),
    (32560, 123, 1, 132, {"cluster": 17.02, "persistent": 23.94,
                          "pair": 41.99}),
    (32560, 123, 4, 132, {"cluster": 19.04, "persistent": 22.68,
                          "pair": 42.68}),
    (32560, 123, 10, 132, {"cluster": 27.04, "persistent": 30.85,
                           "pair": 52.78}),
    (32560, 123, 14, 132, {"cluster": 31.74, "persistent": 32.67,
                           "pair": 63.18}),
    (32560, 123, 15, 0, {"cluster": 33.28, "pair": 63.32}),
    (32560, 123, 16, 0, {"cluster": 33.69, "pair": 65.05}),
    (32560, 123, 17, 0, {"pair": 78.59}),
    (270, 13, 1, 3, {"cluster": 10.67, "persistent": 8.19, "pair": 12.29}),
    (270, 13, 4, 3, {"cluster": 10.89, "persistent": 8.74, "pair": 12.46}),
    (270, 13, 10, 3, {"cluster": 13.63, "persistent": 12.31, "pair": 14.55}),
    (270, 13, 16, 3, {"cluster": 15.96, "persistent": 14.54, "pair": 16.04}),
    (270, 13, 17, 0, {"pair": 14.38}),
]


@pytest.mark.parametrize("n,b,want", [
    (32560, 10, (132, 2, 247, 4)), (32560, 16, (132, 2, 247, 4)),
    (33792, 1, (132, 2, 256, 4)), (33793, 1, None),
    (1000, 10, (14, 7, 72, 2)), (270, 1, (8, 8, 34, 2)),
    (4096, 4, (32, 8, 128, 2)), (1, 1, (8, 8, 1, 2)),
    (1000, 17, None), (1000, 0, None)])
def test_stream_cluster_plan_on_an_h100(n, b, want):
    """The cluster streaming route's plan from the H100's capacity: about
    128 rows a block over whole clusters, every block's slice one tile (256
    rows at most: 33,792 rows at 66 clusters of 2), the smaller tiles, then
    the fewest warps with rows, then the larger clusters (n = 32,560: 8,
    7, 6, 5, 4 or 3 blocks a cluster place too few blocks, so 66 clusters
    of 2); none past 16 lanes; the same whatever the order of the
    capacity table."""
    from repro_torch.kernels.smo_chunk import (StreamClusterPlan,
                                               stream_cluster_plan)
    got = stream_cluster_plan(n, b, H100_STREAM_CLUSTERS)
    assert got == (StreamClusterPlan(*want) if want else None)
    assert got == stream_cluster_plan(
        n, b, dict(reversed(H100_STREAM_CLUSTERS.items())))
    assert stream_cluster_plan(n, b, {}) is None
    if got:
        assert got.blocks % got.cluster == 0
        assert n <= got.blocks * got.slice   # (tiny n leaves blocks empty)
        assert got.slice <= 64 * got.rb


@pytest.mark.parametrize("n,d,b,m,cluster,want", [
    (32560, 123, 10, 132, True, "cluster"),
    (32560, 123, 1, 132, True, "cluster"),
    (32560, 123, 15, 0, True, "cluster"),
    (1000, 123, 10, 8, True, "cluster"),
    (1000, 123, 16, 8, True, "persistent"),
    (270, 13, 10, 3, True, "persistent"),
    (1000, 123, 4, 8, False, "persistent"),
    (1000, 123, 17, 0, False, "pair"),
    (1000, 123, 4, 0, False, "pair")])
def test_stream_route_picks(n, d, b, m, cluster, want):
    """``stream_route``: the fastest placed one-launch route by the fitted
    model (the cluster route at the paper's n = 32,560 and at adult n =
    1,000 x 10 lanes, the persistent route at heart's d = 13 and at 16
    lanes of tiles of 128 rows), the persistent route where only it places
    the lanes (lanes with their own X), else pairs."""
    from repro_torch.kernels.smo_chunk import (stream_cluster_plan,
                                               stream_route)
    plan = stream_cluster_plan(n, b, H100_STREAM_CLUSTERS) if cluster \
        else None
    assert (plan is not None) == cluster
    assert stream_route(n, d, b, m, plan) == want


def test_stream_route_model_holds_the_recorded_sweep():
    """At every point of the H100 sweep recorded above, the route the model
    picks (from the plans the card gives there) ran within 5% of the
    fastest placed route (chip_smoke.py's CHUNK_ROUTE_MARGIN), and a route
    is placed exactly where the sweep timed it."""
    from repro_torch.kernels.smo_chunk import (stream_cluster_plan,
                                               stream_route)
    for n, d, b, m, us in STREAM_SWEEP_H100:
        plan = stream_cluster_plan(n, b, H100_STREAM_CLUSTERS)
        assert ("cluster" in us) == (plan is not None), (n, b)
        assert ("persistent" in us) == (m >= 1), (n, b)
        pick = stream_route(n, d, b, m, plan)
        assert us[pick] <= 1.05 * min(us.values()), (n, d, b, pick)


def test_stream_cluster_workspace_and_tiles():
    """The cluster route's workspace: the barrier counter, then two
    parities of a 48-byte record (16-byte key, 32-byte row) a lane, kind
    and cluster; and tiles of 128 rows up to 128-row slices, else 256."""
    from repro_torch.kernels.smo_chunk import (StreamClusterPlan,
                                               stream_cluster_workspace,
                                               stream_tile_rb)
    assert stream_cluster_workspace(10, StreamClusterPlan(132, 2, 247, 4)) \
        == 16 + 2 * 10 * 2 * 66 * 48
    assert [stream_tile_rb(s) for s in (1, 128, 129, 256)] == [2, 2, 4, 4]


def test_cluster_plan_prefers_portable_then_fewest_rows_an_sm():
    """The card is asked for portable clusters only (2 to 8 blocks); of
    the shapes that place every lane, the plan takes the fewest rows an SM,
    then the smaller cluster, then fewer rows a thread; 88 lanes of 8,192
    rows on an H100: 4-block clusters at 16 rows a thread (the 8-block
    ones carry as many rows an SM)."""
    from repro_torch.kernels.smo_chunk import CLUSTER_SIZES, cluster_plan
    assert min(CLUSTER_SIZES) == 2 and max(CLUSTER_SIZES) == 8
    cap = {(4, 8): 100, (8, 4): 100, (8, 8): 100, (2, 16): 100}
    got = cluster_plan(4096, 2, cap, 132)
    assert (got.blocks, got.rows, got.threads, got.load) == (8, 4, 128, 512)
    got = cluster_plan(4096, 132, {(8, 4): 200, (4, 8): 200}, 132)
    assert (got.blocks, got.rows, got.threads, got.load) == (4, 8, 128,
                                                             4096)
    got = _h100_cluster(8192, 88)
    assert (got.blocks, got.rows, got.threads, got.load) == (4, 16, 128,
                                                             6144)


@pytest.mark.parametrize("n", [1, 33, 1000, 8192, 32544])
@pytest.mark.parametrize("m", [2, 5, 8, 16])
@pytest.mark.parametrize("rows", [4, 32])
def test_cluster_threads_cover_the_lane(n, m, rows):
    """A cluster's blocks hold every row of the lane, in whole warps, with
    less than a warp's rows to spare in a block."""
    from repro_torch.kernels.smo_chunk import cluster_threads
    t = cluster_threads(n, m, rows)
    assert t % 32 == 0 and t >= 32 and m * t * rows >= n
    assert t == 32 or (t - 32) * rows < -(-n // m)


@pytest.mark.parametrize("n", [270, 1000])
def test_one_block_plan_takes_table1(n):
    """Every Table-1 lane (heart n=270, adult n=1000; one lane, or the ten
    of the batched rows) is held by the resident one-block kernel, in
    registers, whatever the multi-block plan gives (m blocks a lane, 0 to
    one a 256 rows) and with or without the cluster plan an H100 makes."""
    from repro_torch.kernels.smo_chunk import chunk_route, one_block_plan
    rows, threads, smem = one_block_plan(n)
    assert not smem and threads <= 1024
    assert rows * threads >= n > rows * (threads - 32)
    for lanes in (1, 10):
        for cluster in (None, _h100_cluster(n, lanes)):
            for m in range(0, -(-n // 256) + 1):
                assert chunk_route(n, lanes, m, cluster,
                                   H100_SMS) == "one_block"


@pytest.mark.parametrize("n", [6145, 8192, 32560])
def test_one_block_plan_refuses_large_lanes(n):
    """Past 6,144 rows no resident build holds a lane: where neither the
    multi-block plan (m = 0) nor the cluster plan places the lanes, they
    keep one block each on the global-state kernel."""
    from repro_torch.kernels.smo_chunk import chunk_route, one_block_plan
    assert one_block_plan(n) is None
    assert chunk_route(n, 1, 0, None, H100_SMS) == "one_block_global"


def test_resident_rows_fit_their_builds():
    """Each entry of the placement table names one build, its widest
    block within a block's 1,024 threads (each build's own limit, read
    from the built kernel, is checked on the card), and (in shared memory)
    its state, 33 bytes a row, within a block's 227 KB beside the static
    slots; the entries rise, and each takes every n up to its bound."""
    from repro_torch.kernels.smo_chunk import (RESIDENT_BUILDS,
                                               RESIDENT_ROWS,
                                               one_block_plan,
                                               resident_threads)
    assert len(set(RESIDENT_BUILDS)) == len(RESIDENT_ROWS)
    lows = [0] + [most for most, _, _ in RESIDENT_ROWS[:-1]]
    for low, (most, rows, smem) in zip(lows, RESIDENT_ROWS):
        assert most > low
        threads = resident_threads(most, rows)
        assert threads <= 1024
        if smem:
            assert 33 * rows * threads + 4 * 32 * 64 <= 232_448
        for n in (low + 1, most):
            assert one_block_plan(n)[::2] == (rows, smem)


def test_cpu_tensors_count_no_route():
    """The plain versions on CPU tensors add to no route's count, the RBF
    kernel's forced routes included."""
    ops.reset_launch_counts()
    q = torch.from_numpy(RNG.normal(size=(1, 2, 9, 64))).to(torch.bfloat16)
    ops.flash_attention(q, q, q)
    X = torch.from_numpy(RNG.normal(size=(20, 5)))
    K = ops.rbf_kernel_matrix(X, X, 0.5)
    for route in ("tensor", "fma"):
        torch.testing.assert_close(
            ops.rbf_kernel_matrix(X, X, 0.5, _route=route), K, rtol=0, atol=0)
    y = torch.where(torch.arange(20) % 2 == 0, 1.0, -1.0).double()
    ops.smo_chunk(K, torch.diagonal(K).contiguous(), y,
                  torch.ones(20, dtype=torch.bool), 1.0, 1e-3, 100, 5, "2",
                  torch.zeros(20, dtype=torch.float64), -y, torch.tensor(0),
                  torch.tensor(False), _route="multi_block")
    sq = torch.sum(X * X, -1)
    for route in ("persistent", "cluster"):
        ops.smo_stream_chunk(X, sq, 0.5, y,
                             torch.ones((1, 20), dtype=torch.bool), [1.0],
                             1e-3, [100], 5,
                             torch.zeros((1, 20), dtype=torch.float64),
                             -y[None], torch.zeros(1, dtype=torch.int64),
                             torch.zeros(1, dtype=torch.bool), _route=route)
    # ATO's ramp step on both pairs of routes
    from repro_torch.kernels.seeding import ato_system_buffers
    Cs, on = torch.ones(1, dtype=torch.float64), torch.ones(20, dtype=bool)
    one = lambda t: t[None].clone()  # noqa: E731
    state = (one(y.abs() * 0.5), one(-y), torch.zeros(1, dtype=torch.float64),
             on, ~on, one(~on), one(on))
    s = ato_system_buffers(1, 20, 4, "cpu")
    for route in ("compact", "carried"):
        ops.ato_system_lanes(K, y, Cs, *state, 4, out=s, _route=route)
    for carry in (None, ref.AtoCarry(K, on, ~on, state[2], s)):
        ops.ato_apply_lanes(one(y), *state[1::-1], s.v, one(y), y, s.b, Cs,
                            1e-3, s.train_now, s.free, *state[5:],
                            torch.zeros(1, dtype=torch.bool),
                            torch.zeros(1, dtype=torch.int64), 30,
                            carry=carry)
    # the LOO spills: the fused entries and the split kernels
    alpha = y.abs() * 0.5
    for t in (0, 19):
        ops.avg_spill_loo(y, alpha, 1.0, t)
        ops.top_spill_loo(K, y, alpha, 1.0, t)
    beta, resid, lo, hi, free0 = ref.loo_start_ref(y, alpha, 1.0, 3)
    ops.avg_spill(beta, lo, hi, free0, resid)
    ops.top_spill(ref.loo_order_ref(K[:, 3], 3), beta, lo, hi, resid)
    assert ops.route_counts() == {
        "rbf_kernel_matrix": {"tensor": 0, "fma": 0},
        "smo_chunk": {"one_block": 0, "multi_block": 0, "cluster": 0,
                      "one_block_global": 0},
        "smo_chunk_sources": {"one_block": 0, "multi_block": 0,
                              "cluster": 0, "one_block_global": 0},
        "smo_stream_chunk": {"pair": 0, "persistent": 0, "cluster": 0},
        "smo_stream_chunk_sources": {"pair": 0, "persistent": 0},
        "flash_attention": {"fma": 0, "mma": 0, "wgmma": 0},
        "ato_system_lanes": {"compact": 0, "carried": 0},
        "ato_apply_lanes": {"split": 0, "fused": 0},
        "avg_spill": {"fused": 0, "split": 0},
        "top_spill": {"fused": 0, "split": 0},
        "mlstm_parallel": {"wgmma": 0, "mma": 0, "fma": 0},
        "slstm_scan": {"block": 0, "cluster": 0}}


def test_window_counts_reset_and_skip_the_plain_version():
    """``window_counts`` splits flash_attention's launches into windowed and
    global ones: the reset zeroes both, and the plain version on CPU
    tensors, with a window or without, adds to neither."""
    ops.flash_attention.window_launches = {"windowed": 3, "global": 2}
    ops.reset_launch_counts()
    assert ops.window_counts() == {"windowed": 0, "global": 0}
    q = torch.from_numpy(RNG.normal(size=(1, 4, 9, 16)))
    ops.flash_attention(q, q[:, :2], q[:, :2], window=3)
    ops.flash_attention(q, q[:, :2], q[:, :2])
    assert ops.window_counts() == {"windowed": 0, "global": 0}


@pytest.mark.parametrize("window", [0, -3, 2.5])
def test_flash_wrapper_rejects_bad_window(window):
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, q, q, window=window)


def test_flash_wrapper_rejects_mixed_devices():
    """Tensors on the CPU and elsewhere: raise, never fall back."""
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA device"):
        ops.flash_attention(q, q.to("meta"), q)


def test_chunk_wrapper_rejects_bad_wss():
    K = torch.eye(4, dtype=torch.float64)
    with pytest.raises(ValueError, match="wss"):
        ops.smo_chunk_lanes(K, torch.ones(4, dtype=torch.float64),
                            torch.ones(4, dtype=torch.float64),
                            torch.ones((1, 4), dtype=torch.bool), [1.0],
                            1e-3, [10], 5, "3",
                            torch.zeros((1, 4), dtype=torch.float64),
                            torch.zeros((1, 4), dtype=torch.float64),
                            torch.zeros(1, dtype=torch.int64),
                            torch.zeros(1, dtype=torch.bool))


def test_chunk_wrapper_rejects_other_devices():
    K = torch.eye(4, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        ops.smo_chunk_lanes(K, K[0], K[0], torch.ones((1, 4), dtype=torch.bool,
                                                      device="meta"),
                            [1.0], 1e-3, [10], 5, "2", K[:1], K[:1],
                            torch.zeros(1, dtype=torch.int64, device="meta"),
                            torch.zeros(1, dtype=torch.bool, device="meta"))


@pytest.mark.parametrize("name", ["rbf", "smo_update", "smo_chunk",
                                  "smo_step", "smo_stream", "seeding",
                                  "flash_attention", "selective_scan",
                                  "mlstm", "slstm"])
def test_build_flags_per_source(name):
    """The SVM sources keep -fmad=false, which their bitwise parity with
    the plain versions needs, and so does the sLSTM recurrence, which
    writes the reference's FMAs itself; the attention, scan and mLSTM
    sources, held to tolerances, drop it. Every source targets sm_90a,
    and none links libcuda."""
    from repro_torch.kernels import _build
    flags = _build.flags(name)
    assert ("-fmad=false" in flags) == (
        name not in ("flash_attention", "selective_scan", "mlstm"))
    assert "arch=compute_90a,code=sm_90a" in flags
    assert not any(f.startswith("-lcuda") for f in flags)
    assert name in _build.SOURCES


def test_build_fma_variant_of_the_step():
    """The witness build of ``smo_step.cu`` (float64 dot products on the FMA
    pipes) compiles the same file with the same flags and one macro more,
    into a library of its own; the source reads the macro."""
    from repro_torch.kernels import _build
    assert _build.source("smo_step_fma") == _build.source("smo_step")
    assert _build.flags("smo_step_fma") == (_build.flags("smo_step")
                                            + ("-DSMO_STEP_TENSOR_F64=0",))
    assert _build.lib_path("smo_step_fma") != _build.lib_path("smo_step")
    assert "SMO_STEP_TENSOR_F64" in _build.source("smo_step").read_text()


def test_build_fma_variant_of_the_stream_chunk():
    """The witness build of ``smo_stream.cu`` (the cluster route's float64
    dot products on the FMA pipes) compiles the same file with the same
    flags and the step's macro, into a library of its own; the source
    reads the macro."""
    from repro_torch.kernels import _build
    assert _build.source("smo_stream_fma") == _build.source("smo_stream")
    assert _build.flags("smo_stream_fma") == (_build.flags("smo_stream")
                                              + ("-DSMO_STEP_TENSOR_F64=0",))
    assert _build.lib_path("smo_stream_fma") != _build.lib_path("smo_stream")
    assert "SMO_STEP_TENSOR_F64" in _build.source("smo_stream").read_text()


def test_build_water_fill_witness():
    """The one-level witness build of ``seeding.cu`` compiles the same file
    with the same flags and one macro more, into a library of its own; the
    source reads the macro."""
    from repro_torch.kernels import _build
    assert _build.source("water_fill_seq") == _build.source("seeding")
    assert _build.flags("water_fill_seq") == (_build.flags("seeding")
                                              + ("-DWATER_FILL_LEVELS=1",))
    assert _build.lib_path("water_fill_seq") != _build.lib_path("seeding")
    assert "WATER_FILL_LEVELS" in _build.source("seeding").read_text()


def test_build_slstm_chain_variant():
    """The chain-only build of ``slstm.cu`` (its cluster route's serial
    chain, timed as that design's floor) compiles the same file with the
    same flags and one macro more, into a library of its own; the source
    reads the macro."""
    from repro_torch.kernels import _build
    assert _build.source("slstm_chain") == _build.source("slstm")
    assert _build.flags("slstm_chain") == (_build.flags("slstm")
                                           + ("-DSLSTM_CHAIN_ONLY=1",))
    assert _build.lib_path("slstm_chain") != _build.lib_path("slstm")
    assert "SLSTM_CHAIN_ONLY" in _build.source("slstm").read_text()


def test_build_slstm_refused_cluster_variant():
    """The build whose cluster no card places (``slstm_cluster32``, for
    the card test that its launch raises) compiles ``slstm.cu`` with the
    same flags and the cluster's block count set past the 16 an H100
    places, into a library of its own; the source reads the macro, and
    the card runs it at the default, 16."""
    from repro_torch.kernels import _build
    assert _build.source("slstm_cluster32") == _build.source("slstm")
    assert _build.flags("slstm_cluster32") == (
        _build.flags("slstm") + ("-DSLSTM_CLUSTER_BLOCKS=32",))
    assert _build.lib_path("slstm_cluster32") != _build.lib_path("slstm")
    src = _build.source("slstm").read_text()
    assert "#ifndef SLSTM_CLUSTER_BLOCKS\n#define SLSTM_CLUSTER_BLOCKS 16\n" \
        in src


@pytest.mark.parametrize("n,m_cap,p", [(1, 1, 0.5), (10, 10, 1.0),
                                       (100, 128, 0.3), (257, 128, 0.2),
                                       (1000, 512, 0.0), (1000, 384, 0.35)])
def test_compact_is_padded_nonzero(n, m_cap, p):
    """The plain compaction (prefix sum + scatter, no host sync) is
    ``torch.nonzero`` padded with 0 to m_cap, the working set ATO's
    ``jnp.nonzero(size=m_cap)`` gives."""
    for seed in range(3):
        mask = torch.from_numpy(np.random.default_rng(seed).random(n) < p)
        nz = torch.nonzero(mask).flatten()[:m_cap]
        want = torch.zeros(m_cap, dtype=torch.long)
        want[:nz.shape[0]] = nz
        assert torch.equal(ref.compact_ref(mask, m_cap), want)


@pytest.mark.parametrize("n,target", [(27, 0.3), (100, -5.0), (243, 1e9),
                                      (900, 0.0), (17, -1e9)])
def test_water_fill_early_stop_is_bitwise(n, target):
    """Stopping the bisection once (c_lo, c_hi) repeat gives the 100-step
    result bit for bit, infeasible targets included."""
    rng = np.random.default_rng(n)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    lo, hi = np.where(y > 0, 0.0, -7.0), np.where(y > 0, 7.0, 0.0)
    beta = np.clip(rng.normal(size=n) * 3, lo, hi)
    args = [torch.from_numpy(a) for a in (beta, lo, hi)]
    early = ref.water_fill_ref(*args, target)
    full = ref.water_fill_ref(*args, target, stop_early=False)
    assert torch.equal(early, full)
    assert torch.equal(ops.water_fill(*args, target), full)


@pytest.mark.parametrize("case", ["feasible", "above", "below"])
@pytest.mark.parametrize("stop_early", [True, False])
@pytest.mark.parametrize("levels", [1, 2, 3, 4, 5])
def test_water_fill_levels_model_is_the_plain_loop(levels, stop_early, case):
    """The card kernel's rounds (``levels`` levels of the bisection tree a
    round, the path walked after one barrier) give the one-level loop's
    result bit for bit, with early stop on and off, on a feasible target
    and on targets above sum(hi) and below sum(lo) (clamped)."""
    rng = np.random.default_rng(40 + levels)
    n = 137
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    lo, hi = np.where(y > 0, 0.0, -7.0), np.where(y > 0, 7.0, 0.0)
    beta = np.clip(rng.normal(size=n) * 3, lo, hi)
    target = {"feasible": float(beta.sum()) * 0.3,
              "above": float(hi.sum()) + 20.0,
              "below": float(lo.sum()) - 20.0}[case]
    args = [torch.from_numpy(a) for a in (beta, lo, hi)]
    for iters in (100, 7):
        want = ref.water_fill_ref(*args, target, iters, stop_early)
        got = ref.water_fill_levels_ref(*args, target, iters, stop_early,
                                        levels)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64))


def _sir_lists_case(case, rng):
    """K_RT, y_R, y_T, alpha_R, priority for the list model: tied values
    and priorities, a NaN and a -inf entry, one label only, label-skewed
    folds, and more or fewer rows than candidates."""
    m, t = {"more_t": (30, 70), "more_r": (70, 30)}.get(case, (50, 50))
    K = rng.random((m, t))
    K[:, 1::3] = K[:, 0:-1:3][:, :K[:, 1::3].shape[1]]   # ties in a row
    y_R = np.where(rng.random(m) < 0.5, 1.0, -1.0)
    y_T = np.where(rng.random(t) < 0.5, 1.0, -1.0)
    if case == "nan_inf":
        K[3, 7] = np.nan
        K[3, 20] = np.nan
        K[5, :] = -np.inf
        K[8, 2:9] = -np.inf
        K[:, 11] = np.nan
    elif case == "one_label":
        y_R[:], y_T[:] = 1.0, 1.0
    elif case == "skewed":
        y_R[: 2 * m // 3] = -1.0
        y_T[: t // 4] = -1.0
        y_T[t // 4:] = 1.0
    priority = rng.random(t)
    priority[5::7] = priority[0]   # tied priorities
    return [torch.from_numpy(a) for a in
            (K, y_R, y_T, rng.random(m) * 3, priority)]


@pytest.mark.parametrize("fallback", ["random", "skip"])
@pytest.mark.parametrize("L,segment", [(1, 0), (2, 0), (4, 0), (32, 0),
                                       (1, 7), (4, 16)])
@pytest.mark.parametrize("case", ["mixed", "nan_inf", "one_label", "skewed",
                                  "more_t", "more_r"])
def test_sir_greedy_lists_model_is_the_plain_pass(case, L, segment,
                                                  fallback):
    """The card pass's phases (each removed row's top-L same-label
    candidates among the t unused when its segment starts, then the walk
    with its rescans and fallbacks; one segment or several) pick what the
    plain pass picks, bit for bit; the short lists do rescan."""
    args = _sir_lists_case(case, np.random.default_rng(len(case) + L))
    events = {}
    got = ref.sir_greedy_lists_ref(*args, fallback, L, events, segment)
    want = ref.sir_greedy_ref(*args, fallback)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    if L == 1 and segment == 0 and case in ("mixed", "one_label"):
        assert events["rescans"] > 0
    if case in ("skewed", "more_r"):
        assert events["fallbacks"] > 0


@pytest.mark.parametrize("m,want", [(0, 1024), (100, 1024), (3256, 1024),
                                    (4096, 1024), (6512, 2048),
                                    (10853, 2048)])
def test_sir_segment_rule(m, want):
    """SIR's walk takes segments of 1,024 removed rows up to 4,096 rows,
    else 2,048 (one segment at Table 1's sizes)."""
    from repro_torch.kernels.seeding import sir_segment
    assert sir_segment(m) == want


def test_sir_lists_model_orders_like_argmax():
    """A list is the row's same-label candidates in argmax's order: NaN
    first, then the larger value, then the lower index; -inf is none and
    -0.0 ties with 0.0."""
    K = torch.tensor([[0.5, float("nan"), -0.0, 0.0, float("-inf"), 0.5,
                       float("nan"), 0.9]])
    y_R = torch.tensor([1.0])
    y_T = torch.tensor([1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, -1.0])
    lists, head = ref.sir_lists_ref(K, y_R, y_T, 8)
    assert lists[0].tolist() == [1, 6, 0, 5, 2, 3] + [ref.SIR_NONE] * 2
    assert head[0].tolist() == [6, 2]
    lists, head = ref.sir_lists_ref(K, -y_R, y_T, 1)
    assert lists[0].tolist() == [7] and head[0].tolist() == [1, 1 << 8]


def test_sir_candidate_lists_runs_its_plain_version_on_the_cpu():
    """On CPU tensors the card phase's wrapper is ``sir_lists_ref`` over the
    (R, T) block, read through the index sets as on the card (it raised
    before: the contract's plain path on the CPU)."""
    from repro_torch.kernels.seeding import sir_candidate_lists
    K = torch.from_numpy(RNG.normal(size=(12, 12)))
    y = torch.where(torch.arange(12) % 3 == 0, -1.0, 1.0).double()
    R, T = torch.tensor([0, 4, 7]), torch.tensor([1, 2, 5, 8, 9, 11])
    lists, head = sir_candidate_lists(K, y[R], y[T], 8, R_idx=R, T_idx=T)
    want = ref.sir_lists_ref(K[R][:, T], y[R], y[T], 8)
    assert torch.equal(lists, want[0]) and torch.equal(head, want[1])
    lists, head = sir_candidate_lists(K[R][:, T], y[R], y[T], 8)
    assert torch.equal(lists, want[0]) and torch.equal(head, want[1])


def test_smo_select_refuses_a_device_other_than_cpu_or_cuda():
    """A tensor neither on the CPU nor on CUDA raises before any launch
    (it reached the kernel's entry before)."""
    n, d = 6, 3
    meta = torch.device("meta")
    X = torch.empty((n, d), dtype=torch.float64, device=meta)
    lane = lambda *shape, dtype=torch.float64: torch.empty(  # noqa: E731
        shape, dtype=dtype, device=meta)
    with pytest.raises(ValueError, match="unsupported device"):
        ops.smo_select(X, lane(n), 0.5, lane(n), lane(1, n, dtype=torch.bool),
                       [1.0], 1e-3, [10], lane(1, n), lane(1, n),
                       lane(1, dtype=torch.int64), lane(1, dtype=torch.bool))


def test_ato_done_step_is_the_identity():
    """A ramp step leaves a lane that starts with its stop flag set (alpha,
    f, T_act, R_act, its step count and its working set, carried or
    recomputed) as it was, bit for bit, while the lane beside it steps;
    the fused apply of that step equals the split apply, then
    ``smo_f_update`` and the clamp, bit for bit, on both lanes."""
    from repro_torch.core.seeding import _ato_step
    from repro_torch.kernels.seeding import ato_system_buffers
    rng = np.random.default_rng(5)
    n, C = 120, 4.0
    X = torch.from_numpy(rng.normal(size=(n, 3)))
    K = ref.rbf_kernel_matrix_ref(X, X, 0.3)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    in_T = torch.from_numpy(rng.random(n) < 0.1)
    in_S = ~in_T
    alpha = torch.from_numpy(np.where(rng.random(n) < 0.5, 0.0,
                                      rng.random(n) * C)) * (~in_T)
    f = torch.from_numpy(rng.normal(size=n))
    two = lambda t: t.expand(2, *t.shape).clone()  # noqa: E731
    state = [two(alpha), two(f), two(in_T), torch.zeros((2, n), dtype=bool),
             torch.tensor([True, False]), torch.tensor([2, 2])]
    before = [s.clone() for s in state]
    Cs = torch.full((2,), C, dtype=torch.float64)
    b_fb = torch.zeros(2, dtype=torch.float64)
    for carried in (False, True):
        for t, b in zip(state, before):
            t.copy_(b)
        sys_ = ato_system_buffers(2, n, 128, "cpu")
        ops.ato_system_lanes(K, y, Cs, *state[:2], b_fb, in_S, in_T,
                             *state[2:4], 128, out=sys_)
        kept = [t[0].clone() for t in sys_]
        # the split step on copies, from the same system
        split = [t.clone() for t in state]
        split_sys = ref.AtoSystem(*(t.clone() for t in sys_))
        _ato_step(K, y, Cs, 1e-3, b_fb, in_S, in_T, 128, 30, *state,
                  torch.zeros((2, n), dtype=torch.float64), sys_, carried)
        for t, b in zip(state, before):
            assert torch.equal(t[0], b[0])
        assert int(state[5][1]) == 3
        # lane 0's working set as the step found it (B and rhs[1:] are
        # the step's own, rewritten every step)
        for key in ref.ATO_CARRIED:
            assert torch.equal(getattr(sys_, key)[0], kept[
                ref.AtoSystem._fields.index(key)]), key
        assert torch.equal(sys_.rhs[0, 0], kept[-1][0])
        # lane 1 stepped: the split route, then the f-update and the clamp
        s2 = ops.ato_system_lanes(K, y, Cs, *split[:2], b_fb, in_S, in_T,
                                  *split[2:4], 128)
        for key in ("B", "idx", "lane", "yM", "v", "w", "b"):
            assert torch.equal(getattr(s2, key), getattr(split_sys, key))
        r = s2.rhs[:, 1:]
        for idx, w, r_l in zip(s2.idx, s2.w, r):
            torch.mv(K.index_select(0, idx), w, out=r_l)
        r.mul_(s2.yM)
        sol = torch.linalg.solve_ex(s2.B, s2.rhs).result[:, 1:]
        Phi = torch.zeros((2, n), dtype=torch.float64).scatter_add(
            1, s2.idx, torch.where(s2.lane & torch.isfinite(sol), sol, 0.0))
        g = torch.stack([K @ u for u in s2.w - y * Phi])
        eta = ref.ato_apply_lanes_ref(g, split[1], split[0], s2.v, Phi, y,
                                      s2.b, Cs, 1e-3, s2.train_now, s2.free,
                                      *split[2:], 30)
        a2 = torch.clamp(ops.smo_f_update(split[0], s2.v, Phi, eta),
                         torch.zeros((2, 1), dtype=torch.float64),
                         Cs[:, None])
        for got, want in zip(state, [a2] + split[1:]):
            assert torch.equal(got.view(torch.uint8), want.view(torch.uint8))


def _ato_ramp_case(seed, n, t_n, one_label=False, bound=False):
    """A row of three lanes (C = 0.5, 3, 30) over one transition: K an RBF
    matrix of 3-d points, T rows at 0, alpha with rows free and at both
    bounds (``bound``: every row at a bound, nf = 0), f = K (alpha y) - y.
    Returns ``_ato_ramp``'s arguments and ``m_cap``."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 3))
    y = np.ones(n) if one_label else np.where(rng.random(n) < 0.5, 1.0, -1.0)
    perm = rng.permutation(n)
    T, R = perm[:t_n], perm[t_n:2 * t_n]
    K = np.exp(-0.5 * ((X[:, None] - X[None]) ** 2).sum(-1))
    Cs = (0.5, 3.0, 30.0)
    alpha, f = [], []
    for C in Cs:
        u = rng.random(n)
        a = np.where(u < 0.4, 0.0, np.where(u < 0.6, C, rng.random(n) * C))
        if bound:
            a = np.where(u < 0.5, 0.0, C)
        a[T] = 0.0
        alpha.append(a)
        f.append(K @ (a * y) - y)
    in_T, in_R = np.zeros(n, bool), np.zeros(n, bool)
    in_T[T], in_R[R] = True, True
    t = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    nf0 = max(int(((a > 0) & (a < C) & ~in_T & ~in_R).sum())
              for a, C in zip(alpha, Cs))
    from repro_torch.core.seeding import _bucket_cap
    return ((t(K), t(y), t(np.array(Cs)), t(np.stack(alpha)),
             t(np.stack(f)), t(np.linspace(-0.1, 0.1, 3)),
             t(~(in_T | in_R)), t(in_T), t(in_R)),
            _bucket_cap(nf0 + t_n, n))


#: (seed, n, |T|, one label, every row at a bound) and what the ramp shows
ATO_RAMPS = {
    "finish_apart": ((3, 80, 8, False, False), "done_apart"),
    "padded": ((4, 300, 20, False, False), "done_apart"),
    "nf_zero": ((3, 300, 20, False, True), "nf_zero"),
    "graduate_all": ((0, 80, 8, False, False), "no_T_left"),
    "one_label": ((8, 120, 12, True, False), "done_apart"),
}


@pytest.mark.parametrize("case", sorted(ATO_RAMPS))
def test_ato_carried_set_is_the_recomputed_set(case, monkeypatch):
    """Over every step of a ramp of three lanes, the working set that the
    fused apply hands the next step (the plain model, ``ato_carry_ref``,
    with nothing recomputed in between) is ``ato_system_lanes_ref`` on the
    state that step starts from, every field but B and rhs[1:] bit for
    bit, lanes that are done included; B from it is the recomputed B; and
    the ramp's seed is the one recomputing every step gives. The cases:
    lanes that finish at different steps (m_cap = n, and padded), a lane
    with no free row, a lane whose T rows all graduate, one label."""
    import repro_torch.core.seeding as cs
    (args, m_cap), show = _ato_ramp_case(*ATO_RAMPS[case][0]), \
        ATO_RAMPS[case][1]
    K, y, Cs, alpha, f, b_fb, in_S, in_T, in_R = args
    real = cs.ato_system_lanes
    seen = {"done": [], "nf": [], "T": []}

    def carried(K_, y_, Cs_, a_, f_, bfb_, S_, T_, T_act, R_act, m_,
                *, out, _route):
        want = ref.ato_system_lanes_ref(K_, y_, Cs_, a_, f_, bfb_, S_, T_,
                                        T_act, R_act, m_)
        if _route == "compact":
            return real(K_, y_, Cs_, a_, f_, bfb_, S_, T_, T_act, R_act, m_,
                        out=out, _route=_route)
        for key in ref.ATO_CARRIED:
            assert torch.equal(getattr(out, key).view(torch.uint8),
                               getattr(want, key).view(torch.uint8)), key
        assert torch.equal(out.rhs[:, 0], want.rhs[:, 0])
        B = ref.ato_b_ref(K_, out.idx, out.yM, out.nf, out.lam)
        assert torch.equal(B, want.B)
        out.B.copy_(B)
        seen["nf"] += out.nf.tolist()
        seen["T"] += T_act.sum(1).tolist()
        return out

    done_at = []
    real_step = cs._ato_step

    def step(*a):
        real_step(*a)
        done_at.append(a[13].tolist())

    monkeypatch.setattr(cs, "ato_system_lanes", carried)
    monkeypatch.setattr(cs, "_ato_step", step)
    got = cs._ato_ramp(*args, 1e-3, m_cap, 30, 1)
    monkeypatch.undo()
    want = cs._ato_ramp(*args, 1e-3, m_cap, 30, 1)
    assert torch.equal(got.view(torch.int64), want.view(torch.int64))
    assert len(done_at) >= 3
    first = {next(k for k, d in enumerate(done_at) if d[l]) for l in range(3)}
    assert {"done_apart": len(first) > 1, "nf_zero": 0 in seen["nf"],
            "no_T_left": 0 in seen["T"]}[show]
    if case == "padded":
        assert m_cap < y.shape[0]


@pytest.mark.parametrize("n", [37, 300, 1100])
def test_ato_fused_apply_is_split_update_clamp(n):
    """The fused plain apply (``carry``) gives the split apply, then
    ``smo_f_update`` and the clamp, bit for bit over three lanes, one of
    them done (it changes nothing), and writes the working set
    ``ato_system_lanes_ref`` gives on the state it leaves."""
    rng = np.random.default_rng(n)
    K = ref.rbf_kernel_matrix_ref(torch.from_numpy(rng.normal(size=(n, 4))),
                                  torch.from_numpy(rng.normal(size=(n, 4))),
                                  0.3)
    Cs = torch.tensor([0.1, 10.0, 1000.0], dtype=torch.float64)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    in_T = torch.from_numpy(rng.random(n) < 0.1)
    in_S = ~in_T & torch.from_numpy(rng.random(n) < 0.9)
    mk = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    alpha = mk(np.where(rng.random((3, n)) < 0.4, 0.0,
                        rng.random((3, n)))) * Cs[:, None]
    f = mk(rng.normal(size=(3, n)))
    T_act = in_T & mk(rng.random((3, n)) < 0.7)
    R_act = ~in_S & ~in_T & (alpha > 0)
    b_fb = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)
    m_cap = n
    s = ref.ato_system_lanes_ref(K, y, Cs, alpha, f, b_fb, in_S, in_T,
                                 T_act, R_act, m_cap)
    g = mk(rng.normal(size=(3, n)) * np.where(rng.random((3, n)) < 0.1, 0.0,
                                              1.0))
    Phi = torch.where(s.free, mk(rng.normal(size=(3, n))), 0.0)
    done, step = torch.tensor([False, True, False]), torch.tensor([3, 5, 29])
    split = [t.clone() for t in (alpha, f, T_act, R_act, done, step)]
    eta_s = ref.ato_apply_lanes_ref(g, split[1], split[0], s.v, Phi, y, s.b,
                                    Cs, 1e-3, s.train_now, s.free,
                                    *split[2:], 30)
    split[0] = torch.clamp(ops.smo_f_update(split[0], s.v, Phi, eta_s),
                           torch.zeros((3, 1), dtype=torch.float64),
                           Cs[:, None])
    fused = [t.clone() for t in (alpha, f, T_act, R_act, done, step)]
    sf = ref.AtoSystem(*(t.clone() for t in s))
    eta_f = ops.ato_apply_lanes(g, fused[1], fused[0], sf.v, Phi, y, sf.b,
                                Cs, 1e-3, sf.train_now, sf.free, *fused[2:],
                                30, carry=ref.AtoCarry(K, in_S, in_T, b_fb,
                                                       sf))
    assert torch.equal(eta_f.view(torch.int64), eta_s.view(torch.int64))
    for a, b in zip(fused, split):
        assert torch.equal(a.view(torch.uint8), b.view(torch.uint8))
    nxt = ref.ato_system_lanes_ref(K, y, Cs, *fused[:2], b_fb, in_S, in_T,
                                   *fused[2:4], m_cap)
    for key in ref.ATO_CARRIED:
        want = torch.where(done.reshape((3,) + (1,) * (getattr(
            s, key).dim() - 1)), getattr(s, key), getattr(nxt, key))
        assert torch.equal(getattr(sf, key), want), key
    assert torch.equal(sf.rhs[:, 0], torch.where(done, s.rhs[:, 0],
                                                 nxt.rhs[:, 0]))


@pytest.mark.parametrize("n,d", [(1, 1), (31, 13), (257, 123), (1000, 9)])
def test_seq_norms_is_the_ordered_sum(n, d):
    """The selection kernel's norm table: each row's |x|^2 summed in order
    of k with each product and each sum rounded on its own (Python floats
    round op by op), bit for bit, over rows of mixed magnitudes, where
    another order would round otherwise."""
    from repro_torch.kernels.smo_chunk import seq_norms
    X = RNG.normal(size=(n, d)) * 10.0 ** RNG.integers(-3, 4, size=(n, 1))
    want = []
    for row in X.tolist():
        s = 0.0
        for v in row:
            s = s + v * v
        want.append(s)
    got = seq_norms(torch.from_numpy(X))
    assert got.dtype == torch.float64
    assert torch.equal(got, torch.tensor(want, dtype=torch.float64))


def test_seq_norms_table_is_checked():
    """The card's streaming wrappers require a norm table of
    ``seq_norms(X)``'s shape and type; none is made from X."""
    from repro_torch.kernels.smo_chunk import _norms_arg, seq_norms
    X = torch.from_numpy(RNG.normal(size=(20, 5)))
    assert torch.equal(_norms_arg(X, seq_norms(X)), seq_norms(X))
    for bad in (None, torch.zeros(19, dtype=torch.float64),
                torch.zeros(20, dtype=torch.float32)):
        with pytest.raises(ValueError, match="seq_norms"):
            _norms_arg(X, bad)


def test_streaming_source_keeps_its_norm_table():
    """``PallasRBF`` makes the table once (``seq_norms`` of its X) and the
    batched chunk hands it to the streaming chunk; on the CPU the chunk is
    the plain loop, which it leaves as it was."""
    from repro_torch.kernels.smo_chunk import seq_norms
    from repro_torch.svm.engine import PallasRBF
    X = torch.from_numpy(RNG.normal(size=(40, 7)))
    src = PallasRBF(X, 0.3)
    assert src.seq_norms is src.seq_norms
    assert torch.equal(src.seq_norms, seq_norms(X))
