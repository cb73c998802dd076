"""The port's CUDA kernels against their plain PyTorch versions, on the
card. These tests import no jax (the GPU machine has none) and skip
without a CUDA device; run them there with

    PYTHONPATH=src python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

RNG = np.random.default_rng(7)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-10),
                                        (torch.float32, 1e-5)])
def test_cuda_rbf_matches_plain(cuda, dtype, atol):
    """Both routes at every tile within the stated tolerance of the plain
    version (float64 has both, float32 the FMA kernel only)."""
    from repro_torch.kernels.rbf import FMA_TILES, TENSOR_TILES
    X = torch.from_numpy(RNG.normal(size=(257, 70))).to(cuda, dtype)
    Z = torch.from_numpy(RNG.normal(size=(130, 70))).to(cuda, dtype)
    want = ref.rbf_kernel_matrix_ref(X, Z, 0.37)
    forced = [("fma", t) for t in FMA_TILES]
    if dtype == torch.float64:
        forced += [("tensor", t) for t in TENSOR_TILES]
    for route, tile in forced:
        got = ops.rbf_kernel_matrix(X, Z, 0.37, _route=route, _tile=tile)
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


#: ragged sizes of the RBF kernel's bitwise checks
RBF_ROWS = (1, 7, 129, 1000, 4099)


def _rbf_fma(X, Z, gamma, tile=64):
    return ops.rbf_kernel_matrix(X, Z, gamma, _route="fma", _tile=tile)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [1, 3, 4, 5, 16, 17, 123, 128, 129])
def test_cuda_rbf_tensor_route_bitwise_equals_fma(cuda, d):
    """The float64 tensor route gives the FMA kernel's bits (tiles 64 and
    32) over ragged n, m and d, at the tile it picks; every forced tile
    too at two shapes."""
    from repro_torch.kernels.rbf import TENSOR_TILES
    gamma = 1.0 / d
    for n in RBF_ROWS:
        for m in RBF_ROWS:
            X = torch.from_numpy(RNG.normal(size=(n, d))).to(cuda)
            Z = torch.from_numpy(RNG.normal(size=(m, d))).to(cuda)
            want = _rbf_fma(X, Z, gamma)
            assert torch.equal(_rbf_fma(X, Z, gamma, 32), want), (n, m)
            tiles = TENSOR_TILES if (n, m) in ((129, 1000), (4099, 7)) \
                else (None,)
            for tile in tiles:
                got = ops.rbf_kernel_matrix(X, Z, gamma, _tile=tile)
                assert torch.equal(got, want), (n, m, tile)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 5), (7, 3), (129, 17), (1000, 123),
                                 (4098, 123), (4099, 128)])
def test_cuda_rbf_z_is_x_bitwise_equals_copy(cuda, n, d):
    """K(X, X) from one tensor, and from two equal slices of one tensor
    (the SVM paths' ``X[:n], X[:n]``), computes the tiles on and above the
    diagonal only; it equals K(X, copy of X), every tile computed, and the
    FMA kernel, bit for bit, at every tile (odd n: 8-byte mirror stores;
    odd d: padded rows)."""
    from repro_torch.kernels.rbf import TENSOR_TILES, same_operand
    gamma = 1.0 / d
    X = torch.from_numpy(RNG.normal(size=(n + 3, d))).to(cuda)
    Xn = X[:n].clone()
    assert same_operand(X[:n], X[:n]) and not same_operand(Xn, Xn.clone())
    want = ops.rbf_kernel_matrix(Xn, Xn.clone(), gamma)
    assert torch.equal(want, _rbf_fma(Xn, Xn, gamma))
    for tile in (None,) + TENSOR_TILES:
        for A, B in ((Xn, Xn), (X[:n], X[:n])):
            got = ops.rbf_kernel_matrix(A, B, gamma, _tile=tile)
            assert torch.equal(got, want), tile


@pytest.mark.cuda
def test_cuda_rbf_nan_and_inf_like_fma(cuda):
    """NaN and +-inf in X and Z give the FMA kernel's outputs (NaN where it
    has NaN), on distinct operands and on K(X, X)."""
    X = torch.from_numpy(RNG.normal(size=(300, 19)))
    X[3, 5], X[10, 0], X[20, 7] = float("nan"), float("inf"), -float("inf")
    Z = torch.from_numpy(RNG.normal(size=(130, 19)))
    Z[4, 2], Z[9, 1], Z[100, 18] = float("nan"), float("inf"), -float("inf")
    X, Z = X.to(cuda), Z.to(cuda)
    for A, B in ((X, Z), (X, X), (Z, X)):
        want = _rbf_fma(A, B, 0.1)
        got = ops.rbf_kernel_matrix(A, B, 0.1)
        assert bool(torch.isnan(want).any())
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


@pytest.mark.cuda
def test_cuda_rbf_underflow_to_zero_like_fma(cuda):
    """A gamma large enough that K underflows to 0 off the diagonal: the
    tensor route's zeros (and its diagonal) are the FMA kernel's."""
    X = torch.from_numpy(RNG.normal(size=(257, 33))).to(cuda)
    Z = torch.from_numpy(RNG.normal(size=(190, 33))).to(cuda)
    for A, B in ((X, X), (X, Z)):
        want = _rbf_fma(A, B, 1e3)
        got = ops.rbf_kernel_matrix(A, B, 1e3)
        assert torch.equal(got, want)
        assert int((got == 0).sum()) >= A.shape[0] * (B.shape[0] - 1)


@pytest.mark.cuda
def test_cuda_rbf_route_counts(cuda):
    """float64 takes the tensor route, float32 the FMA kernel; forcing the
    FMA kernel counts there; the tensor route refuses float32."""
    X = torch.from_numpy(RNG.normal(size=(40, 6))).to(cuda)
    ops.reset_launch_counts()
    ops.rbf_kernel_matrix(X, X, 0.5)
    assert ops.route_counts()["rbf_kernel_matrix"] == {"tensor": 1, "fma": 0}
    ops.rbf_kernel_matrix(X.float(), X.float(), 0.5)
    ops.rbf_kernel_matrix(X, X, 0.5, _route="fma")
    assert ops.route_counts()["rbf_kernel_matrix"] == {"tensor": 1, "fma": 2}
    assert ops.launch_counts()["rbf_kernel_matrix"] == 3
    with pytest.raises(ValueError, match="route"):
        ops.rbf_kernel_matrix(X.float(), X.float(), 0.5, _route="tensor")


@pytest.mark.cuda
def test_cuda_f_update_bitwise_vs_cpu(cuda):
    f, Ki, Kj = (torch.from_numpy(RNG.normal(size=(10_000,)))
                 for _ in range(3))
    want = ref.smo_f_update_ref(f, Ki, Kj, 0.37)
    got = ops.smo_f_update(f.to(cuda), Ki.to(cuda), Kj.to(cuda), 0.37)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
def test_cuda_chunk_bitwise_vs_plain_steps(cuda, wss):
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("heart", n_override=150)
    X = torch.from_numpy(ds.X).to(cuda)
    y = torch.from_numpy(ds.y).to(cuda, torch.float64)
    K = ops.rbf_kernel_matrix(X, X, ds.gamma)
    n = K.shape[0]
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    mask[:15] = False
    state = (torch.zeros(n, dtype=torch.float64, device=cuda), -y,
             torch.tensor(0, device=cuda), torch.tensor(False, device=cuda))
    args = (K, torch.diagonal(K).contiguous(), y, mask, ds.C, 1e-3, 10**6,
            10**6, wss)
    plain = ref.smo_chunk_ref(*args, *state, update_f=ops.smo_f_update)
    got = ops.smo_chunk(*args, *state)
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_chunk_halts_on_nan_like_plain(cuda):
    """A NaN in f on an active row freezes the state at once (CUDA's
    fmin/fmax would drop the NaN; the kernel's reductions keep it)."""
    X = torch.from_numpy(RNG.normal(size=(64, 5))).to(cuda)
    K = ops.rbf_kernel_matrix(X, X, 0.5)
    y = torch.where(torch.arange(64, device=cuda) % 3 == 0, 1.0, -1.0)
    y = y.to(torch.float64)
    f0 = -y.clone()
    f0[3] = float("nan")
    state = (torch.zeros(64, dtype=torch.float64, device=cuda), f0,
             torch.tensor(0, device=cuda), torch.tensor(False, device=cuda))
    args = (K, torch.diagonal(K).contiguous(), y,
            torch.ones(64, dtype=torch.bool, device=cuda), 10.0, 1e-3, 10**6,
            10**6, "2")
    got = ops.smo_chunk(*args, *state)
    plain = ref.smo_chunk_ref(*args, *state, update_f=ops.smo_f_update)
    assert int(got[2]) == int(plain[2]) == 0 and bool(got[3])
    assert torch.equal(got[0], plain[0])


@pytest.mark.cuda
def test_cuda_chunk_bitwise_vs_plain_steps_many_rows_per_thread(cuda):
    """At n=3000 the resident one-block kernel holds 8 rows a thread in
    shared memory and the global-state kernel's 1024 threads each stride
    over three rows, so their per-thread (value, index) accumulations run;
    the run stops at it_cap, so the cap's freeze is compared too."""
    n = 3000
    X = torch.from_numpy(RNG.normal(size=(n, 20))).to(cuda)
    K = ops.rbf_kernel_matrix(X, X, 0.05)
    y = torch.where(torch.arange(n, device=cuda) % 3 == 0, 1.0, -1.0)
    y = y.to(torch.float64)
    mask = torch.ones(n, dtype=torch.bool, device=cuda)
    mask[:300] = False
    state = (torch.zeros(n, dtype=torch.float64, device=cuda), -y,
             torch.tensor(0, device=cuda), torch.tensor(False, device=cuda))
    args = (K, torch.diagonal(K).contiguous(), y, mask, 10.0, 1e-3, 200, 201,
            "2")
    plain = ref.smo_chunk_ref(*args, *state, update_f=ops.smo_f_update)
    for route in ("one_block", "one_block_global"):
        got = ops.smo_chunk(*args, *state, _route=route)
        assert int(got[2]) == 200 and bool(got[3])
        for a, b in zip(got, plain):
            assert torch.equal(a, b)


def _pair_case(n, d, b, dtype, dev):
    """The reference's ``fused_smo_step`` test problem
    (``tests/test_kernels.py::_step_problem``: normal X and f, pair rows
    (3, n - 1), delta 0.37, gamma 0.5 below) widened to b lanes, each with
    its own f. In f64 lanes 1.. take random pairs. In f32 every lane keeps
    the reference's pair: its bar holds for those values, while at a pair's
    own row d2 cancels to 0 from terms of |x|^2 ~ d, an error of delta *
    gamma * a few ulp(2 |x|^2) in any summation order."""
    X = torch.from_numpy(RNG.normal(size=(n, d))).to(dev, dtype)
    pairs = torch.from_numpy(RNG.integers(0, n, size=(b, 2))).to(dev)
    pairs[0] = torch.tensor([3, n - 1])
    if dtype == torch.float32:
        pairs[:] = torch.tensor([3, n - 1])
    xij = X[pairs]
    f = torch.from_numpy(RNG.normal(size=(b, n))).to(dev, dtype)
    delta = torch.full((b,), 0.37, dtype=dtype, device=dev)
    return f, X, xij, torch.sum(X * X, -1), delta


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(257, 9), (100, 130), (120, 40)])
@pytest.mark.parametrize("dtype,atol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-5)])
def test_cuda_fused_smo_step_matches_plain(cuda, n, d, dtype, atol):
    """One lane (the reference's signature) and 4 lanes, one of them done,
    on the reference's ragged shapes, at the reference's bars."""
    f, X, xij, sq, delta = _pair_case(n, d, 4, dtype, cuda)
    one = ops.fused_smo_step(f[0], X, xij[0], sq, 0.37, 0.5)
    torch.testing.assert_close(
        one, ref.fused_smo_step_ref(f[0], X, xij[0], sq, 0.37, 0.5),
        rtol=0, atol=atol)
    done = torch.tensor([False, True, False, False], device=cuda)
    got = ops.fused_smo_step(f, X, xij, sq, delta, 0.5, done=done)
    want = ref.fused_smo_step_ref(f, X, xij, sq, delta, 0.5, done)
    torch.testing.assert_close(got, want, rtol=0, atol=atol)
    assert torch.equal(got[1], f[1])
    # a lane's result does not depend on the lanes launched beside it
    assert torch.equal(got[0], one)


def _lane_problem(cuda, n, b):
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("heart", n_override=n)
    X = torch.from_numpy(ds.X).to(cuda)
    y = torch.from_numpy(ds.y).to(cuda, torch.float64)
    masks = torch.ones((b, n), dtype=torch.bool, device=cuda)
    for l in range(b):
        masks[l, l * (n // b):(l + 1) * (n // b)] = False
    state = (torch.zeros((b, n), dtype=torch.float64, device=cuda),
             -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64, device=cuda),
             torch.zeros(b, dtype=torch.bool, device=cuda))
    return ds, X, y, masks, state


@pytest.mark.cuda
def test_cuda_lane_grid_chunk_equals_one_lane(cuda):
    """Each lane of the dense lane grid (with a pad lane that arrives done)
    is bitwise the one-lane launch."""
    ds, X, y, masks, state = _lane_problem(cuda, 150, 4)
    K = ops.rbf_kernel_matrix(X, X, ds.gamma)
    diag = torch.diagonal(K).contiguous()
    caps = [10**6, 10**6, 300, 0]
    dn = state[3].clone()
    dn[3] = True
    got = ops.smo_chunk_lanes(K, diag, y, masks, [ds.C] * 4, 1e-3, caps,
                              10**6, "2", state[0], state[1], state[2], dn)
    for l in range(3):
        one = ops.smo_chunk(K, diag, y, masks[l], ds.C, 1e-3, caps[l], 10**6,
                            "2", state[0][l], state[1][l], state[2][l],
                            state[3][l])
        for a, b in zip(one, got):
            assert torch.equal(a, b[l])
    assert int(got[2][3]) == 0 and torch.equal(got[1][3], state[1][3])


@pytest.mark.cuda
def test_cuda_stream_chunk_width_invariant_and_near_plain(cuda):
    """The streaming chunk: a lane alone and packed at width 4 is bitwise
    the same; against the plain loop on the card within 1e-10 after a
    capped run."""
    ds, X, y, masks, state = _lane_problem(cuda, 150, 4)
    sq = torch.sum(X * X, -1)
    caps = [200] * 4
    args = (X, sq, ds.gamma, y)
    got = _stream_chunk(*args, masks, [ds.C] * 4, 1e-3, caps, 250,
                        *state)
    for l in range(4):
        one = _stream_chunk(*args, masks[l:l + 1], [ds.C], 1e-3,
                            caps[l:l + 1], 250,
                            *(t[l:l + 1] for t in state))
        for a, b in zip(one, got):
            assert torch.equal(a[0], b[l])
    plain = ref.smo_chunk_ref(None, torch.ones_like(y), y, masks[0], ds.C,
                              1e-3, 200, 250, "1", state[0][0], state[1][0],
                              state[2][0], state[3][0],
                              stream=(X, sq, ds.gamma))
    assert int(got[2][0]) == int(plain[2]) == 200
    for k in (0, 1):
        torch.testing.assert_close(got[k][0], plain[k], rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_cuda_stream_chunk_stops_after_the_lanes(cuda):
    """On the pair route a long chunk stops within 128 iterations of its
    last lane's stop, with the state of chunks short enough to launch every
    iteration; the persistent route stops on the device, in one launch."""
    ds, X, y, masks, state = _lane_problem(cuda, 150, 4)
    sq = torch.sum(X * X, -1)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 4, 1e-3, [10 ** 6] * 4)
    before = ops.launch_counts()["fused_smo_step"]
    got = _stream_chunk(*args, 10 ** 6, *state, _route="pair")
    issued = ops.launch_counts()["fused_smo_step"] - before
    assert bool(got[3].all())
    assert int(got[2].max()) < issued <= int(got[2].max()) + 128
    short = state
    while not bool(short[3].all()):
        short = _stream_chunk(*args, 64, *short, _route="pair")
    for a, b in zip(got, short):
        assert torch.equal(a, b)
    before = ops.launch_counts()
    one = _stream_chunk(*args, 10 ** 6, *state, _route="persistent")
    after = ops.launch_counts()
    assert after["smo_stream_chunk"] == before["smo_stream_chunk"] + 1
    assert after["fused_smo_step"] == before["fused_smo_step"]
    for a, b in zip(one, got):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_select_matches_plain(cuda):
    """The selection kernel alone against its plain version: the same
    pairs (so bitwise pair rows), alpha and delta within 1e-12, the same
    counts and freezes (one lane arrives done, one is at its cap)."""
    ds, X, y, masks, state = _lane_problem(cuda, 150, 4)
    sq = torch.sum(X * X, -1)
    n_iter = torch.tensor([0, 5, 0, 3], device=cuda)
    done = torch.tensor([False, False, True, False], device=cuda)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 4, 1e-3, [100, 100, 100, 3],
            state[0], state[1], n_iter, done)
    got = _select(*args)
    # on CPU tensors the wrapper runs the plain version
    want = [t.to(cuda) for t in _select(
        *(a.cpu() if isinstance(a, torch.Tensor) else a for a in args))]
    for k in (1, 2, 3):
        assert torch.equal(got[k], want[k])
    for k in (0, 4):
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("S,D,causal,window", [
    (64, 32, True, None), (100, 32, False, None), (128, 64, True, 24),
    (96, 16, False, 40), (33, 32, True, None),
])
def test_cuda_flash_attention_matches_plain(cuda, S, D, causal, window):
    """The reference's sweep (``tests/test_kernels.py``), f32 atol 2e-5."""
    q, k, v = (torch.from_numpy(RNG.normal(size=(2, 3, S, D))).to(
        cuda, torch.float32) for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_cuda_flash_attention_bf16_matches_plain(cuda):
    q, k, v = (torch.from_numpy(RNG.normal(size=(1, 2, 64, 32))).to(
        cuda, torch.bfloat16) for _ in range(3))
    got = ops.flash_attention(q, k, v)
    want = ref.flash_attention_ref(q, k, v)
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=0.06)


def _row_rel(got, want) -> float:
    """max over rows of max |got - want| / max |want| (a row: the last
    axis), a measure that keeps its meaning however small the outputs."""
    w = want.float()
    err = (got.float() - w).abs().amax(-1)
    return float((err / w.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,D,causal,window", [
    (2, 3, 3, 64, 32, True, None), (2, 3, 3, 100, 32, False, None),
    (2, 3, 3, 128, 64, True, 24), (2, 3, 3, 96, 16, False, 40),
    (2, 3, 3, 33, 32, True, None), (2, 8, 2, 300, 128, True, None),
    (1, 4, 1, 200, 128, False, 70), (2, 8, 2, 1000, 128, True, 256),
])
def test_cuda_flash_attention_bf16_rows_vs_f32_plain(cuda, B, H, KV, S, D,
                                                      causal, window):
    """bf16 on the tensor-core path (several kv tiles, ragged S, windows,
    grouped kv heads read through (B, S, H, D) strides) against the plain
    version run in float32 on the same bf16 inputs, row by row: within
    0.02 of each row's largest output and within twice the bf16 plain
    version's own error; and within the reference's 0.06 of the plain
    version in bf16."""
    q, k, v = (torch.from_numpy(RNG.normal(size=(B, S, h, D))).to(
        cuda, torch.bfloat16).transpose(1, 2) for h in (H, KV, KV))
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = _row_rel(got, want)
    assert err <= 0.02 and err <= 2 * _row_rel(plain, want)
    torch.testing.assert_close(got.float(), plain.float(), rtol=0, atol=0.06)


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
def test_cuda_flash_attention_gqa_strided(cuda, D):
    """kv heads grouped (KV=2 under H=8), read in place from (B, S, H, D)
    tensors through their strides; the output keeps q's layout."""
    q = torch.from_numpy(RNG.normal(size=(2, 70, 8, D))).to(cuda,
                                                            torch.float32)
    k, v = (torch.from_numpy(RNG.normal(size=(2, 70, 2, D))).to(
        cuda, torch.float32) for _ in range(2))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    want = ref.flash_attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                   v.transpose(1, 2))
    assert got.transpose(1, 2).is_contiguous()
    torch.testing.assert_close(got, want, rtol=0, atol=2e-5)


@pytest.mark.cuda
def test_cuda_prefill_goes_through_the_kernel(cuda):
    """A SMOKE granite on the card: every prefill layer launches the kernel
    once, and the logits match the same model on the CPU (f32, whose
    attention is the plain version) within 1e-4."""
    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import prefill_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("granite-8b", smoke=True)
    cpu = init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = init_model(cfg, seed=0, dtype=torch.float32, device="cpu").to(cuda)
    batch = concrete_batch(cfg, 2, 40, device="cpu")
    before = ops.launch_counts()["flash_attention"]
    got = prefill_logits(card, {"tokens": batch["tokens"].to(cuda)})
    assert ops.launch_counts()["flash_attention"] - before == cfg.n_layers
    want = prefill_logits(cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_cuda_flash_attention_bf16_running_max_holds(cuda, route):
    """Every key the same, with scores in the millions (q = k = 254 at D =
    128): every row's attention is uniform over the keys it sees. The
    running max holds from the first tile on, so the row's sums must take
    a factor of exactly 1 a tile; a factor 2^(m c - round(m c)) (0.051 in
    log2 here) compounded over 32 tiles skewed the weights threefold."""
    q = torch.full((1, 2, 4096, 128), 254.0, device=cuda,
                   dtype=torch.bfloat16)
    k = q[:, :1].clone()
    v = torch.from_numpy(RNG.normal(size=(1, 1, 4096, 128))).to(
        cuda, torch.bfloat16)
    got = ops.flash_attention(q, k, v, _route=route)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    assert _row_rel(got, want) <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("D", [128, 256])
@pytest.mark.parametrize("form,S,kw", [
    ("local", 1000, {"window": 256}), ("local", 777, {"window": 128}),
    ("q", 1000, {"causal": True, "q_chunk": 256}),
    ("q", 777, {"causal": False, "window": 100, "q_chunk": 256}),
])
def test_cuda_chunked_attention_is_one_wgmma_launch(cuda, D, form, S, kw):
    """gemma3's local layers (``sdpa_local_chunked``) and ``attn_q_chunk``
    (``sdpa_q_chunked``) on the card without a softcap: one
    flash_attention launch on the wgmma route (ragged S, grouped kv heads
    read through (B, S, H, D) strides), within the bf16 bar of the plain
    form run in float32 on the same inputs, row by row."""
    from repro_torch.models import attention
    fn, plain = ((attention.sdpa_local_chunked,
                  attention.sdpa_local_chunked_plain) if form == "local"
                 else (attention.sdpa_q_chunked,
                       attention.sdpa_q_chunked_plain))
    q, k, v = (torch.from_numpy(RNG.normal(size=(2, S, h, D))).to(
        cuda, torch.bfloat16) for h in (8, 2, 2))
    kind = "global" if form == "q" and "window" not in kw else "windowed"
    before = ops.launch_counts()["flash_attention"]
    wgmma = ops.route_counts()["flash_attention"]["wgmma"]
    windows = ops.window_counts()
    got = fn(q, k, v, **kw)
    assert ops.launch_counts()["flash_attention"] == before + 1
    assert ops.route_counts()["flash_attention"]["wgmma"] == wgmma + 1
    assert ops.window_counts() == {**windows, kind: windows[kind] + 1}
    want = plain(q.float(), k.float(), v.float(), **kw)
    bf16 = plain(q, k, v, **kw)
    assert got.shape == (2, S, 8, D) and got.dtype == torch.bfloat16
    err = _row_rel(got, want)
    assert err <= 0.02 and err <= 2 * _row_rel(bf16, want)


@pytest.mark.cuda
def test_cuda_chunked_attention_with_a_softcap_runs_the_plain_form(cuda):
    """The kernel has no softcap: with one, each chunked form makes no
    launch and is its plain form."""
    from repro_torch.models import attention
    q, k, v = (torch.from_numpy(RNG.normal(size=(1, 300, h, 128))).to(
        cuda, torch.float32) for h in (4, 2, 2))
    before = ops.launch_counts()["flash_attention"]
    for fn, plain, kw in (
            (attention.sdpa_local_chunked,
             attention.sdpa_local_chunked_plain, {"window": 64}),
            (attention.sdpa_q_chunked, attention.sdpa_q_chunked_plain,
             {"q_chunk": 128})):
        got = fn(q, k, v, softcap=30.0, **kw)
        assert torch.equal(got, plain(q, k, v, softcap=30.0, **kw))
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
def test_cuda_gemma3_init_model_allocates_count_params(cuda):
    """gemma3-4b at full width on the card: the parameters allocated are
    ``count_params`` (3,879,907,840), in bf16."""
    from repro_torch.configs import get_config
    from repro_torch.models.transformer import count_params, init_model
    cfg = get_config("gemma3-4b")
    model = init_model(cfg, seed=0, dtype=torch.bfloat16)
    params = list(model.parameters())
    assert sum(p.numel() for p in params) == count_params(cfg) \
        == 3_879_907_840
    assert all(p.is_cuda and p.dtype == torch.bfloat16 for p in params)
    del model, params
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,T,D,causal,window", [
    (2, 8, 2, 300, 300, 64, True, None), (1, 4, 1, 200, 200, 64, False, 70),
    (2, 8, 2, 300, 300, 128, True, None), (1, 4, 1, 200, 200, 128, False, 70),
    (2, 8, 2, 1000, 1000, 128, True, 256), (1, 4, 2, 100, 333, 128, False,
                                            None),
    (2, 4, 2, 77, 77, 256, True, None), (1, 4, 1, 200, 200, 256, False, 70),
    (2, 8, 2, 1000, 1000, 256, True, 256),
])
def test_cuda_flash_attention_wgmma_route(cuda, B, H, KV, S, T, D, causal,
                                         window):
    """The wgmma route at head dims 64, 128 and 256 (ragged S and T,
    windows, grouped kv heads read through (B, S, H, D) strides) against
    the plain version in float32 on the same bf16 inputs, row by row
    (within 0.02 of each row's largest output and twice the bf16 plain
    version's error), and counted on its route."""
    q = torch.from_numpy(RNG.normal(size=(B, S, H, D))).to(
        cuda, torch.bfloat16).transpose(1, 2)
    k, v = (torch.from_numpy(RNG.normal(size=(B, T, KV, D))).to(
        cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    before = ops.route_counts()["flash_attention"]["wgmma"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.route_counts()["flash_attention"]["wgmma"] == before + 1
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = _row_rel(got, want)
    assert err <= 0.02 and err <= 2 * _row_rel(plain, want)
    # the mma.sync route on the same inputs, to the same gate
    old = ops.flash_attention(q, k, v, causal=causal, window=window,
                              _route="mma")
    err = _row_rel(old, want)
    assert err <= 0.02 and err <= 2 * _row_rel(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,KV,S,T,D,causal,window", [
    (2, 8, 2, 300, 300, 32, True, None), (1, 4, 1, 200, 200, 32, False, 70),
    (2, 8, 2, 1000, 1000, 32, True, 256), (1, 4, 2, 100, 333, 32, False,
                                            None),
    (1, 4, 2, 300, 333, 32, True, None), (2, 4, 4, 513, 513, 32, True, 130),
    (2, 4, 2, 77, 77, 16, True, None), (1, 4, 1, 200, 200, 16, False, 70),
    (2, 8, 2, 1000, 1000, 16, True, 256), (1, 4, 2, 100, 333, 16, False,
                                            None),
    (1, 4, 2, 300, 333, 16, True, None), (2, 4, 4, 513, 513, 16, True, 130),
])
def test_cuda_flash_attention_mma_route(cuda, B, H, KV, S, T, D, causal,
                                        window):
    """The mma.sync route at head dims 16 and 32 (kv tiles of 128 keys:
    several of them, ragged S and T, T > S, windows, tiles masked only
    where they cross the mask, grouped kv heads read through (B, S, H, D)
    strides) against the plain version in float32 on the same bf16
    inputs, row by row (within 0.02 of each row's largest output and twice
    the bf16 plain version's error), and counted on its route."""
    q = torch.from_numpy(RNG.normal(size=(B, S, H, D))).to(
        cuda, torch.bfloat16).transpose(1, 2)
    k, v = (torch.from_numpy(RNG.normal(size=(B, T, KV, D))).to(
        cuda, torch.bfloat16).transpose(1, 2) for _ in range(2))
    before = ops.route_counts()["flash_attention"]["mma"]
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    assert ops.route_counts()["flash_attention"]["mma"] == before + 1
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal, window=window)
    plain = ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    err = _row_rel(got, want)
    assert err <= 0.02 and err <= 2 * _row_rel(plain, want)
    assert got.transpose(1, 2).is_contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["wgmma", "fma"])
@pytest.mark.parametrize("B,H,S,T,causal", [
    (1, 4, 300, 300, True), (2, 3, 200, 200, False), (1, 2, 100, 333, False),
    (1, 2, 333, 333, True), (2, 2, 1000, 1000, True), (1, 2, 77, 77, True),
])
def test_cuda_flash_attention_mla_pair(cuda, dtype, B, H, S, T, causal):
    """MLA's pair, q and k at head dim 192 and v at 128, on the wgmma
    route (bf16) and the FMA route (f32): causal and not, S != T, lengths
    that are no multiple of a tile, q, k and v strided views of (B, S, H,
    D) activations. bf16 against the plain version in float32 on the same
    inputs, row by row (0.02 of each row's largest output and twice the
    bf16 plain version's error); f32 within 2e-5. The output is 128 wide,
    in q's layout, and counted on its route."""
    q = torch.from_numpy(RNG.normal(size=(B, S, H, 192))).to(
        cuda, dtype).transpose(1, 2)
    k = torch.from_numpy(RNG.normal(size=(B, T, H, 192))).to(
        cuda, dtype).transpose(1, 2)
    v = torch.from_numpy(RNG.normal(size=(B, T, H, 128))).to(
        cuda, dtype).transpose(1, 2)
    path = "wgmma" if dtype == torch.bfloat16 else "fma"
    before = ops.route_counts()["flash_attention"][path]
    got = ops.flash_attention(q, k, v, causal=causal)
    assert ops.route_counts()["flash_attention"][path] == before + 1
    assert got.shape == (B, H, S, 128) and got.transpose(1, 2).is_contiguous()
    want = ref.flash_attention_ref(q.float(), k.float(), v.float(),
                                   causal=causal)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=0, atol=2e-5)
    else:
        plain = ref.flash_attention_ref(q, k, v, causal=causal)
        err = _row_rel(got, want)
        assert err <= 0.02 and err <= 2 * _row_rel(plain, want)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,D,Dv,kw", [
    (torch.bfloat16, 24, 16, {}), (torch.float32, 24, 16, {}),
    (torch.bfloat16, 128, 192, {}), (torch.bfloat16, 192, 192, {}),
    (torch.bfloat16, 192, 128, {"_route": "mma"}),
])
def test_cuda_flash_attention_refuses_an_unbuilt_pair(cuda, dtype, D, Dv,
                                                      kw):
    """A (q/k, v) head-dim pair no route is built for raises, and launches
    nothing: SMOKE MLA's (24, 16), the pairs turned round or unequal, and
    the mma.sync route forced at (192, 128)."""
    q = torch.zeros((1, 2, 8, D), dtype=dtype, device=cuda)
    v = torch.zeros((1, 2, 8, Dv), dtype=dtype, device=cuda)
    before = ops.launch_counts()["flash_attention"]
    with pytest.raises(ValueError, match="head dims"):
        ops.flash_attention(q, q, v, **kw)
    assert ops.launch_counts()["flash_attention"] == before


@pytest.mark.cuda
def test_cuda_moe_matches_its_cpu_plain_run(cuda):
    """``moe_apply`` on the card against its CPU run, f32, deepseek-v2's
    SMOKE shape with slots dropping (capacity factor 0.5): the routers pick
    the same experts; fed the same experts, the dispatch's order, buffer
    rows and kept slots are bitwise the CPU's, and so is the combine fed
    the same expert outputs (the fixed slot order, no atomics); the whole
    layer within 1e-5 of its scale (the expert GEMMs sum in other orders),
    and twice on the card bitwise."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-v2-236b", smoke=True).replace(
        capacity_factor=0.5)
    p = init_params(moe.experts_def(cfg), torch.Generator().manual_seed(7),
                    torch.float32, "cpu")
    pc = {k: ({kk: t.to(cuda) for kk, t in v.items()} if isinstance(v, dict)
              else v.to(cuda)) for k, v in p.items()}
    x = torch.from_numpy(RNG.normal(size=(2, 40, cfg.d_model))).float()
    y_cpu, aux_cpu = moe.moe_apply(p, x, cfg, act=cfg.act)
    y, aux = moe.moe_apply(pc, x.to(cuda), cfg, act=cfg.act)
    y2, _ = moe.moe_apply(pc, x.to(cuda), cfg, act=cfg.act)
    assert torch.equal(y, y2)
    scale = float(y_cpu.abs().max())
    torch.testing.assert_close(y.cpu(), y_cpu, rtol=0, atol=1e-5 * scale)
    torch.testing.assert_close(aux.cpu(), aux_cpu, rtol=0, atol=1e-6)
    w, e, _ = moe._route(p, x.reshape(80, -1), cfg)
    _, e_card, _ = moe._route(pc, x.reshape(80, -1).to(cuda), cfg)
    assert torch.equal(e_card.cpu(), e)
    cap = moe.capacity(cfg, 80)
    slots = moe._dispatch(e, cfg.n_experts, cap)
    slots_card = moe._dispatch(e.to(cuda), cfg.n_experts, cap)
    assert not bool(slots[4].all())          # some slots drop
    for a, b in zip(slots_card, slots, strict=True):
        assert torch.equal(a.cpu(), b)
    out = torch.from_numpy(RNG.normal(size=(cfg.n_experts, cap + 1,
                                            cfg.d_model))).float()
    want = moe._combine(out, w, *slots[:2], *slots[3:])
    got = moe._combine(out.to(cuda), w.to(cuda), *slots_card[:2],
                       *slots_card[3:])
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_moe_makes_no_host_sync(cuda):
    """``moe_apply`` on the card, dispatch and combine included, under
    ``set_sync_debug_mode("error")``: the capacity comes from shapes, so
    nothing waits for the card (``jit_lint.SYNC_FREE`` names it)."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    from repro_torch.models.params import init_params
    cfg = get_config("deepseek-v3-671b", smoke=True)
    p = init_params(moe.experts_def(cfg), torch.Generator(cuda).manual_seed(2),
                    torch.bfloat16, cuda)
    x = torch.randn((3, 20, cfg.d_model), device=cuda, dtype=torch.bfloat16)
    moe.moe_apply(p, x, cfg, act=cfg.act)      # warm up (first launches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = moe.moe_apply(p, x, cfg, act=cfg.act)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y.shape == x.shape and bool(torch.isfinite(y).all())


def _narrow_deepseek():
    """deepseek-v2-236b narrowed for a card test: MLA at its full head dims
    (192 for q and k, 128 for v; 4 heads), 3 layers (1 dense + 2 MLA +
    MoE, 8 experts, top 2)."""
    from repro_torch.configs import get_config
    return get_config("deepseek-v2-236b").replace(
        n_layers=3, d_model=256, n_heads=4, n_kv_heads=4, d_ff=512,
        vocab_size=512, q_lora_rank=64, kv_lora_rank=64, n_experts=8,
        n_shared_experts=1, top_k=2, moe_d_ff=64)


@pytest.mark.cuda
def test_cuda_narrow_deepseek_prefill_takes_the_kernel(cuda):
    """A narrowed deepseek-v2 at head dims 192 / 128 on the card: each
    prefill layer is one flash_attention launch (f32: the FMA route;
    bf16: wgmma), the f32 logits within 1e-4 of the same model on the CPU
    (whose attention is the plain version), and teacher-forced decode on
    the card within 1e-4 of the CPU's too."""
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_model)
    from repro_torch.serving import prefill_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _narrow_deepseek()
    cpu = init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = init_model(cfg, seed=0, dtype=torch.float32, device="cpu").to(cuda)
    batch = concrete_batch(cfg, 2, 70, device="cpu")
    fma = ops.route_counts()["flash_attention"]["fma"]
    got = prefill_logits(card, {"tokens": batch["tokens"].to(cuda)})
    assert ops.route_counts()["flash_attention"]["fma"] - fma == cfg.n_layers
    want = prefill_logits(cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    caches = [init_cache(cfg, 2, 6, torch.float32, device=d)
              for d in ("cpu", cuda)]
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        want, _ = decode_step(cpu, caches[0], {"tokens": tok, "step": t})
        got, _ = decode_step(card, caches[1], {"tokens": tok.to(cuda),
                                               "step": t})
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    bf16 = init_model(cfg, seed=0, dtype=torch.bfloat16)
    wgmma = ops.route_counts()["flash_attention"]["wgmma"]
    logits = prefill_logits(bf16, {"tokens": batch["tokens"].to(cuda)})
    assert ops.route_counts()["flash_attention"]["wgmma"] - wgmma \
        == cfg.n_layers
    assert bool(torch.isfinite(logits).all())


@pytest.mark.cuda
def test_cuda_smoke_deepseek_prefill_takes_the_einsum_form(cuda):
    """At SMOKE width MLA's pair is (24, 16), which no route is built for:
    the card's prefill routes by shape to the einsum form and launches no
    kernel, with logits within 1e-4 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import init_model
    from repro_torch.serving import prefill_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("deepseek-v2-236b", smoke=True)
    cpu = init_model(cfg, seed=1, dtype=torch.float32, device="cpu")
    batch = concrete_batch(cfg, 2, 34, device="cpu")
    before = ops.launch_counts()["flash_attention"]
    got = prefill_logits(cpu.to(cuda), {"tokens": batch["tokens"].to(cuda)})
    assert ops.launch_counts()["flash_attention"] == before
    want = prefill_logits(init_model(cfg, seed=1, dtype=torch.float32,
                                     device="cpu"), batch)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)


def _multi_problem(cuda, n, b):
    """adult's first n rows, b lanes, lane l holding out tenth l mod 10."""
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("adult", n_override=n)
    X = torch.from_numpy(ds.X).to(cuda)
    y = torch.from_numpy(ds.y).to(cuda, torch.float64)
    K = ops.rbf_kernel_matrix(X, X, ds.gamma)
    masks = torch.ones((b, n), dtype=torch.bool, device=cuda)
    for l in range(b):
        masks[l, (l % 10) * (n // 10):(l % 10 + 1) * (n // 10)] = False
    state = (torch.zeros((b, n), dtype=torch.float64, device=cuda),
             -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64, device=cuda),
             torch.zeros(b, dtype=torch.bool, device=cuda))
    return ds, K, torch.diagonal(K).contiguous(), y, masks, state


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
def test_cuda_multi_block_chunk_bitwise(cuda, wss):
    """At n=20,000 (78 blocks a lane) the multi-block route is bitwise the
    global-state one-block kernel and the plain step engine after a capped
    run, and three lanes packed are bitwise each lane alone."""
    n = 20_000
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 3)
    args = (K, diag, y, masks[0], ds.C, 1e-3, 200, 201, wss)
    one = tuple(t[0] for t in state)
    before = ops.route_counts()["smo_chunk"]["multi_block"]
    got = ops.smo_chunk(*args, *one)
    assert ops.route_counts()["smo_chunk"]["multi_block"] == before + 1
    assert int(got[2]) == 200 and bool(got[3])
    for want in (ops.smo_chunk(*args, *one, _route="one_block_global"),
                 ref.smo_chunk_ref(*args, *one, update_f=ops.smo_f_update)):
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    caps = [200, 150, 200]
    packed = ops.smo_chunk_lanes(K, diag, y, masks, [ds.C] * 3, 1e-3, caps,
                                 201, wss, *state)
    for l in range(3):
        alone = ops.smo_chunk(K, diag, y, masks[l], ds.C, 1e-3, caps[l], 201,
                              wss, *(t[l] for t in state))
        for a, b in zip(alone, packed):
            assert torch.equal(a, b[l])


@pytest.mark.cuda
def test_cuda_multi_block_chunk_widest_lanes(cuda):
    """At n=32,560 the widest batch the multi-block plan still places (the
    lanes' state fills the card's shared memory, so few blocks a lane)
    runs on that route, bitwise the global-state one-block kernel lane by
    lane; one lane more, which that plan cannot place, takes the cluster
    route (a thread-block cluster a lane; the resident kernel holds no
    lane of 32,560 rows), and its lanes are the same."""
    from repro_torch.kernels.smo_chunk import (_sms, chunk_route,
                                               cluster_capacity,
                                               cluster_plan,
                                               multi_block_plan)
    n = 32_560
    b = 1
    while multi_block_plan(n, b + 1)[0] >= 1:
        b += 1
    wider = cluster_plan(n, b + 1, cluster_capacity(n), _sms())
    assert multi_block_plan(n, b + 1)[0] == 0 and wider is not None
    assert chunk_route(n, b + 1, 0, wider, _sms()) == "cluster"
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, b + 1)
    caps = [100 + 3 * l for l in range(b + 1)]

    def run(w, route=None):
        return ops.smo_chunk_lanes(K, diag, y, masks[:w], [ds.C] * w, 1e-3,
                                   caps[:w], 200, "2",
                                   *(t[:w] for t in state), _route=route)

    before = ops.route_counts()["smo_chunk"]
    got = run(b, "multi_block")
    assert ops.route_counts()["smo_chunk"]["multi_block"] == \
        before["multi_block"] + 1
    assert got[2].tolist() == caps[:b] and bool(got[3].all())
    for a, w in zip(got, run(b, "one_block_global")):
        assert torch.equal(a, w)
    before = ops.route_counts()["smo_chunk"]
    wide = run(b + 1)
    assert ops.route_counts()["smo_chunk"]["cluster"] == \
        before["cluster"] + 1
    for a, w in zip(wide, got):
        assert torch.equal(a[:b], w)


@pytest.mark.cuda
def test_cuda_multi_block_chunk_halts_on_nan(cuda):
    """A NaN in f on a training row freezes the lane at once on the
    multi-block route too, like the plain step."""
    n = 8192
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 1)
    f0 = state[1][0].clone()
    f0[n - 3] = float("nan")
    args = (K, diag, y, masks[0], ds.C, 1e-3, 10**6, 10**6, "2",
            state[0][0], f0, state[2][0], state[3][0])
    got = ops.smo_chunk(*args, _route="multi_block")
    plain = ref.smo_chunk_ref(*args, update_f=ops.smo_f_update)
    assert int(got[2]) == int(plain[2]) == 0 and bool(got[3])
    assert torch.equal(got[0], plain[0])
    assert torch.equal(got[1].isnan(), plain[1].isnan())


# ---- the streaming chunk's persistent route ----

def _stream_problem(cuda, n, b, name="adult"):
    """A dataset's first n rows as a streaming source, b cold lanes, lane l
    holding out tenth l mod 10."""
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset(name, n_override=max(n, 270 if name == "heart" else
                                           1000))
    X = torch.from_numpy(ds.X[:n]).to(cuda)
    y = torch.from_numpy(ds.y[:n]).to(cuda, torch.float64)
    masks = torch.ones((b, n), dtype=torch.bool, device=cuda)
    for l in range(b):
        masks[l, (l % 10) * (n // 10):(l % 10 + 1) * (n // 10)] = False
    state = (torch.zeros((b, n), dtype=torch.float64, device=cuda),
             -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64, device=cuda),
             torch.zeros(b, dtype=torch.bool, device=cuda))
    return ds, X, torch.sum(X * X, -1), y, masks, state


def _stream_chunk(X, *args, **kw):
    """``ops.smo_stream_chunk`` given X's norm table, as a source gives it."""
    from repro_torch.kernels.smo_chunk import seq_norms
    return ops.smo_stream_chunk(X, *args, X_norms=seq_norms(X), **kw)


def _select(X, *args):
    """``ops.smo_select`` given X's norm table, as a source gives it."""
    from repro_torch.kernels.smo_chunk import seq_norms
    return ops.smo_select(X, *args, X_norms=seq_norms(X))


def _step_engine(X, sq, gamma, y, masks, Cs, tol, caps, n_iters, alphas, fs,
                 n_iter, done):
    """The streaming step engine of the two kernels, one iteration at a
    time from the host: ``smo_select`` then ``fused_smo_step`` over its
    pair rows and delta (the selection clips all of alpha every step, the
    chunk only at its first: the same values, clip being idempotent)."""
    for _ in range(n_iters):
        if bool(done.all()):
            break
        alphas, n_iter, done, xij, delta = _select(
            X, sq, gamma, y, masks, Cs, tol, caps, alphas, fs, n_iter, done)
        fs = ops.fused_smo_step(fs, X, xij, sq, delta, gamma, done=done)
    return alphas, fs, n_iter, done


def _routes_equal(a, b):
    """Bitwise equal states, NaN where NaN (a NaN lane keeps its f)."""
    for u, v, what in zip(a, b, ("alpha", "f", "n_iter", "done")):
        if u.is_floating_point():
            assert torch.equal(u.isnan(), v.isnan()), what
            u, v = (torch.where(t.isnan(), 0.0, t) for t in (u, v))
        assert torch.equal(u, v), what


def _select_problem(cuda, n, b, d=9, seed=0):
    """Random rows (n, d), labels, b lanes holding out a tenth each, and
    their cold state."""
    rng = np.random.default_rng(seed)
    X = torch.from_numpy(rng.normal(size=(n, d))).to(cuda)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, -1.0, 1.0)).to(cuda)
    masks = torch.from_numpy(rng.random((b, n)) >= 0.1).to(cuda)
    state = (torch.zeros((b, n), dtype=torch.float64, device=cuda),
             -y.repeat(b, 1), torch.zeros(b, dtype=torch.int64, device=cuda),
             torch.zeros(b, dtype=torch.bool, device=cuda))
    return X, torch.sum(X * X, -1), 0.5 / d, y, masks, state


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16, 17, 20, 32])
@pytest.mark.parametrize("n", [31, 33, 255, 257, 1023, 1025, 4096, 4097])
def test_cuda_select_lanes_and_rows(cuda, b, n):
    """The selection kernel at lane counts around the persistent route's
    16 and rows around a warp, a block (256) and a thread's batch (1,024,
    and 4,096: four batches a thread), at an odd d, cold and after 30
    pair-route iterations: n_iter, done and
    the pair rows bitwise the plain version's, alpha and delta within
    1e-12."""
    X, sq, gamma, y, masks, cold = _select_problem(cuda, n, b, d=13)
    Cs = torch.full((b,), 1.0, dtype=torch.float64, device=cuda)
    caps = torch.full((b,), 10 ** 6, dtype=torch.int64, device=cuda)
    mid = _stream_chunk(X, sq, gamma, y, masks, Cs, 1e-3, caps, 30,
                        *cold, _route="pair")
    for a, f, it, dn in (cold, mid):
        args = (X, sq, gamma, y, masks, Cs, 1e-3, caps, a, f, it, dn)
        got = _select(*args)
        want = ref.smo_select_lanes_ref(*args)
        for k in (1, 2, 3):
            assert torch.equal(got[k], want[k])
        for k in (0, 4):
            torch.testing.assert_close(got[k], want[k], rtol=0, atol=1e-12)


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 16, 17, 20, 32])
@pytest.mark.parametrize("n", [33, 257, 1025, 4097])
def test_cuda_select_pair_route_bitwise_persistent(cuda, b, n):
    """The pair route (the selection kernel and the fused step, per
    iteration) bitwise the persistent route, to convergence: whole when
    the persistent route places the lanes (16 at most), else in packs of
    16 (a lane's bits do not depend on the lanes beside it)."""
    X, sq, gamma, y, masks, state = _select_problem(cuda, n, b, d=13,
                                                    seed=1)
    args = (X, sq, gamma, y)
    got = _stream_chunk(*args, masks, [1.0] * b, 1e-3, [10 ** 6] * b,
                        10 ** 6, *state, _route="pair")
    assert bool(got[3].all())
    for lo in range(0, b, 16):
        hi = min(b, lo + 16)
        pers = _stream_chunk(*args, masks[lo:hi], [1.0] * (hi - lo),
                             1e-3, [10 ** 6] * (hi - lo), 10 ** 6,
                             *(t[lo:hi] for t in state),
                             _route="persistent")
        _routes_equal(tuple(t[lo:hi] for t in got), pers)


@pytest.mark.cuda
def test_cuda_seq_norms_on_the_card_bitwise(cuda):
    """The norm table on the card is the CPU's, bit for bit (each product
    and sum rounded on its own in both)."""
    from repro_torch.kernels.smo_chunk import seq_norms
    X = torch.from_numpy(np.random.default_rng(3).normal(size=(1000, 123)))
    assert torch.equal(seq_norms(X.to(cuda)).cpu(), seq_norms(X))


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,cap", [
    ("heart", 270, 10 ** 6), ("adult", 270, 10 ** 6),
    ("adult", 1000, 10 ** 6), ("adult", 32560, 300)])
def test_cuda_stream_persistent_bitwise(cuda, name, n, cap):
    """One chunk of ten lanes on the persistent route is bitwise the pair
    route and (at n <= 1,000) the step engine of the two kernels: heart
    (one block: the picks stay in shared memory), adult's first 270 and
    1,000 rows (3 and 8 blocks), all to convergence, and adult n=32,560
    (132 blocks) to a cap of 300. Within 1e-10 of the plain loop after 200
    iterations (its products are a matmul, not the kernels' ordered
    fma)."""
    ds, X, sq, y, masks, state = _stream_problem(cuda, n, 10, name)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 10, 1e-3, [cap] * 10)
    before = ops.route_counts()["smo_stream_chunk"]["persistent"]
    got = _stream_chunk(*args, 10 ** 6, *state, _route="persistent")
    assert ops.route_counts()["smo_stream_chunk"]["persistent"] == before + 1
    assert bool(got[3].all())
    _routes_equal(got, _stream_chunk(*args, 10 ** 6, *state,
                                     _route="pair"))
    Cs = torch.full((10,), ds.C, dtype=torch.float64, device=cuda)
    caps = torch.full((10,), cap, device=cuda)
    if n <= 1000:
        _routes_equal(got, _step_engine(X, sq, ds.gamma, y, masks, Cs, 1e-3,
                                        caps, 10 ** 6, *state))
    capped = _stream_chunk(X, sq, ds.gamma, y, masks[:1], [ds.C],
                           1e-3, [200], 201, *(t[:1] for t in state))
    plain = ref.smo_chunk_ref(None, torch.ones_like(y), y, masks[0], ds.C,
                              1e-3, 200, 201, "1",
                              *(t[0] for t in state), stream=(X, sq, ds.gamma))
    assert int(capped[2][0]) == int(plain[2]) == 200
    for k in (0, 1):
        torch.testing.assert_close(capped[k][0], plain[k], rtol=0, atol=1e-10)


@pytest.mark.cuda
def test_cuda_stream_persistent_lane_widths(cuda):
    """At n=32,560: one lane, ten, and the widest batch the persistent plan
    places are bitwise lane by lane the same lanes alone (lanes stop at
    caps spread over the chunk); one lane more it refuses, and the route
    ``stream_route`` takes for it gives the same lanes."""
    from repro_torch.kernels.smo_chunk import stream_plan
    n = 32560
    b = 1
    while stream_plan(n, 123, b + 1)[0] >= 1:
        b += 1
    assert b >= 10
    ds, X, sq, y, masks, state = _stream_problem(cuda, n, b + 1)
    caps = [40 + 7 * l for l in range(b + 1)]

    def run(ids, route=None):
        ids = list(ids)
        return _stream_chunk(X, sq, ds.gamma, y, masks[ids],
                             [ds.C] * len(ids), 1e-3,
                             [caps[l] for l in ids], 500,
                             *(t[ids] for t in state), _route=route)

    for width in (1, 10, b):
        before = ops.route_counts()["smo_stream_chunk"]["persistent"]
        got = run(range(width), "persistent")
        assert ops.route_counts()["smo_stream_chunk"]["persistent"] == \
            before + 1
        assert got[2].tolist() == caps[:width]
        for l in (0, width - 1):
            _routes_equal(run([l], "pair"), tuple(t[l:l + 1] for t in got))
    with pytest.raises(ValueError, match="persistent route cannot place"):
        run(range(b + 1), "persistent")
    wide = run(range(b + 1))
    _routes_equal(tuple(t[:b] for t in wide), got)


@pytest.mark.cuda
def test_cuda_stream_persistent_resumes_and_caps(cuda):
    """A chunk cut by n_iters and resumed is bitwise one chunk, on either
    route; lanes capped mid-chunk freeze there, the others go on."""
    ds, X, sq, y, masks, state = _stream_problem(cuda, 1000, 4)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 4, 1e-3, [50, 10 ** 6,
                                                          333, 10 ** 6])
    whole = _stream_chunk(*args, 10 ** 6, *state)
    assert whole[2].tolist()[0] == 50 and whole[2].tolist()[2] == 333
    for route in ("persistent", "pair"):
        part = state
        while not bool(part[3].all()):
            part = _stream_chunk(*args, 97, *part, _route=route)
        _routes_equal(part, whole)


@pytest.mark.cuda
def test_cuda_stream_persistent_nan_lane(cuda):
    """A NaN in f on a training row freezes its lane at once, as the plain
    step does; the other lanes of the launch are bitwise their runs
    alone."""
    ds, X, sq, y, masks, state = _stream_problem(cuda, 1000, 3)
    fs = state[1].clone()
    fs[1, 997] = float("nan")
    lanes = (state[0], fs, state[2], state[3])
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 3, 1e-3, [10 ** 6] * 3)
    got = _stream_chunk(*args, 10 ** 6, *lanes)
    assert int(got[2][1]) == 0 and bool(got[3][1])
    assert torch.equal(got[0][1], state[0][1])
    for l in (0, 2):
        alone = _stream_chunk(X, sq, ds.gamma, y, masks[l:l + 1],
                              [ds.C], 1e-3, [10 ** 6], 10 ** 6,
                              *(t[l:l + 1] for t in lanes))
        _routes_equal(alone, tuple(t[l:l + 1] for t in got))
    _routes_equal(got, _stream_chunk(*args, 10 ** 6, *lanes,
                                     _route="pair"))


# ---- the streaming chunk's cluster route ----

def _stream_routes_equal(args, kw=None, routes=("cluster", "persistent",
                                                "pair")):
    """The chunk on each of ``routes`` (those that place it), bitwise the
    first's, NaN where NaN; the first's result."""
    kw = kw or {}
    outs = [_stream_chunk(*args, **kw, _route=r) for r in routes]
    for other in outs[1:]:
        _routes_equal(outs[0], other)
    return outs[0]


@pytest.mark.cuda
@pytest.mark.parametrize("b", [1, 4, 10, 16])
@pytest.mark.parametrize("n", [1, 31, 270, 1000, 4096, 32560])
def test_cuda_stream_cluster_bitwise(cuda, n, b):
    """The cluster route is bitwise the persistent witness (where its plan
    places the lanes) and the pair route: adult's first n rows, b lanes
    stopping at caps spread over the chunk (to convergence at n <= 1,000
    otherwise), and a lane of the pack bitwise the lane alone."""
    from repro_torch.kernels.smo_chunk import stream_plan
    ds, X, sq, y, masks, state = _stream_problem(cuda, n, b)
    big = n > 1000
    caps = [40 + 7 * l if big else 10 ** 6 - l for l in range(b)]
    args = (X, sq, ds.gamma, y, masks, [ds.C] * b, 1e-3, caps,
            500 if big else 10 ** 6, *state)
    routes = ("cluster",) + ("persistent",) * (
        stream_plan(n, X.shape[1], b)[0] >= 1) + ("pair",)
    before = ops.route_counts()["smo_stream_chunk"]["cluster"]
    got = _stream_routes_equal(args, routes=routes)
    assert ops.route_counts()["smo_stream_chunk"]["cluster"] == before + 1
    if big:
        assert got[2].tolist() == caps
    for l in {0, b - 1}:
        alone = _stream_chunk(X, sq, ds.gamma, y, masks[l:l + 1], [ds.C],
                              1e-3, caps[l:l + 1], args[8],
                              *(t[l:l + 1] for t in state), _route="cluster")
        _routes_equal(alone, tuple(t[l:l + 1] for t in got))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [270, 1000, 32560])
def test_cuda_stream_cluster_frozen_and_nan_edges(cuda, n):
    """Lanes frozen part-way (done on entry, or at their caps mid-chunk)
    and NaN f on rows at the cluster route's block edges (and so at
    cluster edges, clusters being runs of blocks), on a training row (the
    lane stops at once) and off both sets: the three routes bitwise."""
    from repro_torch.kernels.smo_chunk import (stream_cluster_capacity,
                                               stream_cluster_plan)
    b = 6
    ds, X, sq, y, masks, state = _stream_problem(cuda, n, b)
    plan = stream_cluster_plan(n, b, stream_cluster_capacity(X.shape[1], b))
    edges = sorted({min(n - 1, e) for lo in range(0, n, plan.slice)
                    for e in (lo, lo + plan.slice - 1)})
    fs, done = state[1].clone(), state[3].clone()
    done[4] = True                          # frozen on entry
    train = [e for e in edges if bool(masks[1, e])]
    fs[1, train[len(train) // 2]] = float("nan")  # a training row: stops
    masks[2, edges[1::2]] = False           # off the training set: ignored
    fs[2, edges[1::2]] = float("nan")
    fs[3, edges] = float("nan")
    lanes = (state[0], fs, state[2], done)
    caps = [10 ** 6, 10 ** 6, 60, 10 ** 6, 10 ** 6, 25]
    got = _stream_routes_equal((X, sq, ds.gamma, y, masks, [ds.C] * b, 1e-3,
                                caps, 300, *lanes))
    assert int(got[2][4]) == 0 and torch.equal(got[1][4], fs[4])
    assert int(got[2][1]) == int(got[2][3]) == 0 and bool(got[3][1])
    assert int(got[2][5]) == 25


@pytest.mark.cuda
def test_cuda_stream_cluster_refuses_what_it_cannot_place(cuda):
    """A forced route that cannot place the lanes raises: the cluster route
    past 16 lanes or past its rows (every block's slice one tile), and on
    lanes with their own X (``smo_stream_chunk_sources`` has no cluster
    route)."""
    from repro_torch.kernels.smo_chunk import (pad_rows, seq_norms,
                                               stream_cluster_capacity,
                                               stream_cluster_plan)
    ds, X, sq, y, masks, state = _stream_problem(cuda, 1000, 17)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 17, 1e-3, [10] * 17, 10,
            *state)
    with pytest.raises(ValueError, match="cluster route cannot place"):
        _stream_chunk(*args, _route="cluster")
    wide = 80_000
    assert stream_cluster_plan(wide, 1, stream_cluster_capacity(9, 1)) \
        is None
    Xw = torch.ones((wide, 9), dtype=torch.float64, device=cuda)
    yw = torch.ones(wide, dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="cluster route cannot place"):
        ops.smo_stream_chunk(
            Xw, torch.sum(Xw * Xw, -1), 0.5, yw,
            torch.ones((1, wide), dtype=torch.bool, device=cuda), [1.0],
            1e-3, [1], 1, torch.zeros((1, wide), dtype=torch.float64,
                                      device=cuda), -yw[None],
            torch.zeros(1, dtype=torch.int64, device=cuda),
            torch.zeros(1, dtype=torch.bool, device=cuda),
            X_norms=seq_norms(Xw), _route="cluster")
    Xs = X[None].repeat(2, 1, 1)
    with pytest.raises(ValueError, match="route must be one of"):
        ops.smo_stream_chunk_sources(
            Xs, sq[None].repeat(2, 1), ds.gamma, y[None].repeat(2, 1),
            masks[:2], [ds.C] * 2, 1e-3, [10] * 2, 10,
            *(t[:2] for t in state), X_rows=pad_rows(Xs),
            X_norms=seq_norms(Xs), _route="cluster")


@pytest.mark.cuda
@pytest.mark.parametrize("n", [270, 32560])
def test_cuda_stream_cluster_fma_build_bitwise(cuda, n, monkeypatch):
    """The FP64 tensor cores round like an ordered fma chain: the build of
    ``smo_stream.cu`` with its float64 dot products on the FMA pipes
    (``smo_stream_fma``) gives the cluster route's results bit for bit."""
    from repro_torch.kernels import _build
    ds, X, sq, y, masks, state = _stream_problem(cuda, n, 10)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 10, 1e-3, [200] * 10, 201,
            *state)
    got = _stream_chunk(*args, _route="cluster")
    entry = _build.entry
    monkeypatch.setattr(_build, "entry", lambda name, *a: entry(
        "smo_stream_fma" if name == "smo_stream" else name, *a))
    _routes_equal(got, _stream_chunk(*args, _route="cluster"))


@pytest.mark.cuda
@pytest.mark.parametrize("b", [3, 17])
def test_cuda_fused_smo_step_many_tiles(cuda, b):
    """More tiles than the card has blocks (each block walks several) and
    more lanes than a block stages at once (17: two lane blocks): within
    1e-12 of the plain version, and each lane bitwise its one-lane
    launch."""
    f, X, xij, sq, delta = _pair_case(40_000, 9, b, torch.float64, cuda)
    got = ops.fused_smo_step(f, X, xij, sq, delta, 0.5)
    want = ref.fused_smo_step_ref(f, X, xij, sq, delta, 0.5)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    for l in (0, b - 1):
        assert torch.equal(
            got[l], ops.fused_smo_step(f[l], X, xij[l], sq, 0.37, 0.5))


@pytest.mark.cuda
def test_cuda_stream_persistent_x_rows(cuda):
    """The padded X that a source makes once (``pad_rows``, odd d) gives
    the chunk made per call bitwise; an X_rows with rows off 16-byte
    boundaries is refused."""
    from repro_torch.kernels.smo_chunk import pad_rows
    ds, X, sq, y, masks, state = _stream_problem(cuda, 1000, 3)
    assert X.shape[1] % 2 == 1
    X_rows = pad_rows(X)
    assert X_rows.stride(0) == X.shape[1] + 1 and torch.equal(X_rows, X)
    args = (X, sq, ds.gamma, y, masks, [ds.C] * 3, 1e-3, [10 ** 6] * 3,
            10 ** 6)
    _routes_equal(_stream_chunk(*args, *state, X_rows=X_rows),
                  _stream_chunk(*args, *state))
    with pytest.raises(ValueError, match="X_rows"):
        _stream_chunk(*args, *state, X_rows=X)


@pytest.mark.cuda
@pytest.mark.parametrize("n,b", [(1000, 20), (40_000, 10)])
def test_cuda_fused_smo_step_fma_build_bitwise(cuda, n, b):
    """The FP64 tensor cores round like an ordered fma chain: the build of
    ``smo_step.cu`` with its float64 dot products on the FMA pipes gives
    the fused kernel's outputs bit for bit (20 lanes: two lane blocks)."""
    import ctypes
    from repro_torch.kernels import _build
    f, X, xij, sq, delta = _pair_case(n, 123, b, torch.float64, cuda)
    types = (*(ctypes.c_void_p,) * 6, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_double, ctypes.c_void_p)
    outs = []
    for lib in ("smo_step", "smo_step_fma"):
        out = f.clone()
        fn = _build.entry(lib, "fused_smo_step_f64", *types)
        _build.check(fn(out.data_ptr(), X.data_ptr(), sq.data_ptr(),
                        xij.data_ptr(), delta.data_ptr(), None, n, 123, b,
                        0.5, _build.stream_ptr(out)), lib)
        outs.append(out)
    assert torch.equal(outs[0], outs[1])


# ---- the dense chunk's resident one-block route ----

def _same(got, want):
    """Two chunk results bitwise equal, a NaN matching a NaN."""
    for a, w, what in zip(got, want, ("alpha", "f", "n_iter", "done")):
        if a.is_floating_point():
            assert torch.equal(a.isnan(), w.isnan()), what
            a, w = a.nan_to_num(), w.nan_to_num()
        assert torch.equal(a, w), what


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
@pytest.mark.parametrize("b", [1, 3, 20])
@pytest.mark.parametrize("n", [1, 31, 33, 270, 1000, 2048, 2049, 6144])
def test_cuda_resident_chunk_bitwise(cuda, n, b, wss):
    """The resident one-block route (registers to 2,048 rows, shared
    memory past them, 6,144 the most it places) is bitwise the
    global-state kernel on every lane, capped and to convergence, and the
    plain step engine on the first and last lanes of a capped run."""
    from repro_torch.kernels.smo_chunk import one_block_plan
    assert one_block_plan(n) is not None
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, b)
    Cs = [ds.C] * b
    caps = [120 + 7 * l for l in range(b)]
    for lane_caps in (caps, [10**6] * b):
        lanes = (K, diag, y, masks, Cs, 1e-3, lane_caps, 10**6, wss, *state)
        before = ops.route_counts()["smo_chunk"]["one_block"]
        got = ops.smo_chunk_lanes(*lanes, _route="one_block")
        assert ops.route_counts()["smo_chunk"]["one_block"] == before + 1
        assert bool(got[3].all())
        _same(got, ops.smo_chunk_lanes(*lanes, _route="one_block_global"))
    for l in sorted({0, b - 1}):
        plain = ref.smo_chunk_ref(K, diag, y, masks[l], Cs[l], 1e-3, caps[l],
                                  caps[l] + 1, wss, *(t[l] for t in state),
                                  update_f=ops.smo_f_update)
        got = ops.smo_chunk(K, diag, y, masks[l], Cs[l], 1e-3, caps[l],
                            caps[l] + 1, wss, *(t[l] for t in state),
                            _route="one_block")
        _same(got, plain)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [270, 1000])
def test_cuda_resident_chunk_every_build(cuda, n):
    """Each build of the resident kernel (1, 2, 4 rows a thread in
    registers, 8 in shared memory) that holds n rows gives the same lanes,
    bitwise; a build whose block would be too wide raises."""
    from repro_torch.kernels.smo_chunk import (RESIDENT_BUILDS,
                                               resident_build,
                                               resident_threads)
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 3)
    lanes = (K, diag, y, masks, [ds.C] * 3, 1e-3, [10**6] * 3, 10**6, "2",
             *state)
    want = ops.smo_chunk_lanes(*lanes, _route="one_block_global")
    for build in RESIDENT_BUILDS:
        if resident_threads(n, build[0]) > resident_build(*build)[0]:
            with pytest.raises(ValueError, match="one-block"):
                ops.smo_chunk_lanes(*lanes, _rows=build)
            continue
        _same(ops.smo_chunk_lanes(*lanes, _route="one_block", _rows=build),
              want)


@pytest.mark.cuda
def test_cuda_resident_builds_hold_their_rows(cuda):
    """Each build the placement table names exists on the card and takes
    the widest block the table gives it; one that does not exist raises."""
    from repro_torch.kernels.smo_chunk import (RESIDENT_ROWS,
                                               resident_build,
                                               resident_threads)
    for most, rows, smem in RESIDENT_ROWS:
        threads, regs, _ = resident_build(rows, smem)
        assert resident_threads(most, rows) <= threads <= 1024 and regs > 0
    with pytest.raises(RuntimeError, match="resident_build"):
        resident_build(3, False)


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
def test_cuda_resident_chunk_freezes(cuda, wss):
    """Lanes that arrive done, hold a NaN in f, or reach their cap freeze
    as the plain step does, bitwise, beside a lane that converges; a done
    lane's state is left as it came."""
    n = 1000
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 4)
    Cs = [ds.C] * 4
    alphas, fs, its, dn = (t.clone() for t in state)
    dn[0] = True
    fs[1, n - 5] = float("nan")
    its[2] = 40
    caps = [10**6, 10**6, 97, 10**6]
    lanes = (K, diag, y, masks, Cs, 1e-3, caps, 10**6, wss, alphas, fs, its,
             dn)
    got = ops.smo_chunk_lanes(*lanes)
    _same(got, ops.smo_chunk_lanes(*lanes, _route="one_block_global"))
    assert int(got[2][0]) == 0 and torch.equal(got[1][0], fs[0])
    assert int(got[2][1]) == 0 and bool(got[3][1])
    assert int(got[2][2]) == 97 and bool(got[3][2])
    for l in (1, 2):
        plain = ref.smo_chunk_ref(K, diag, y, masks[l], Cs[l], 1e-3, caps[l],
                                  10**6, wss, alphas[l], fs[l], its[l],
                                  dn[l], update_f=ops.smo_f_update)
        _same(tuple(t[l] for t in got), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
@pytest.mark.parametrize("n", [270, 1000])
def test_cuda_resident_chunk_cut_into_chunks(cuda, n, wss):
    """A capped solve cut into chunks of 1 and of 7 iterations (each
    launch clips all of alpha on its first update) equals one chunk,
    bitwise, on three lanes."""
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 3)
    Cs = [ds.C] * 3
    caps = [150, 203, 260]
    one = ops.smo_chunk_lanes(K, diag, y, masks, Cs, 1e-3, caps, 10**6, wss,
                              *state)
    for step in (1, 7):
        st = state
        while not bool(st[3].all()):
            st = ops.smo_chunk_lanes(K, diag, y, masks, Cs, 1e-3, caps, step,
                                     wss, *st)
        _same(st, one)


# ---- the dense chunk's cluster route ----

def _placed_shapes(n, b):
    """Every (blocks a cluster, rows a thread) of which the card runs b
    clusters at once over n rows."""
    from repro_torch.kernels.smo_chunk import cluster_capacity
    return sorted(s for s, c in cluster_capacity(n).items() if c >= b)


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
@pytest.mark.parametrize("n,b", [(1, 2), (33, 2), (1000, 3), (7000, 5),
                                 (20_000, 4)])
def test_cuda_cluster_chunk_bitwise(cuda, n, b, wss):
    """The cluster route, at every shape the card places for the launch
    (blocks a cluster, rows a thread: so rows past n, blocks with no row
    below n, and every build), is bitwise the global-state kernel on
    lanes with different C and iteration caps, and the plain step engine
    on the first and last lanes."""
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, b)
    Cs = [ds.C * (0.5 + 0.25 * l) for l in range(b)]
    caps = [90 + 37 * l for l in range(b)]
    lanes = (K, diag, y, masks, Cs, 1e-3, caps, 10**6, wss, *state)
    want = ops.smo_chunk_lanes(*lanes, _route="one_block_global")
    shapes = _placed_shapes(n, b)
    assert shapes
    before = ops.route_counts()["smo_chunk"]["cluster"]
    _same(ops.smo_chunk_lanes(*lanes, _route="cluster"), want)
    for shape in shapes:
        _same(ops.smo_chunk_lanes(*lanes, _route="cluster", _cluster=shape),
              want)
    assert ops.route_counts()["smo_chunk"]["cluster"] == \
        before + 1 + len(shapes)
    for l in sorted({0, b - 1}):
        plain = ref.smo_chunk_ref(K, diag, y, masks[l], Cs[l], 1e-3, caps[l],
                                  10**6, wss, *(t[l] for t in state),
                                  update_f=ops.smo_f_update)
        _same(tuple(t[l] for t in want), plain)


@pytest.mark.cuda
@pytest.mark.parametrize("wss", ["2", "1"])
def test_cuda_cluster_chunk_freezes(cuda, wss):
    """Lanes that arrive done, hold a NaN in f, or reach their cap freeze
    on the cluster route as the plain step does, bitwise, beside a lane
    that converges; a done lane's state is left as it came."""
    n = 7000
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 4)
    Cs = [ds.C] * 4
    alphas, fs, its, dn = (t.clone() for t in state)
    dn[0] = True
    fs[1, n - 5] = float("nan")
    its[2] = 40
    caps = [10**6, 10**6, 97, 400]
    lanes = (K, diag, y, masks, Cs, 1e-3, caps, 10**6, wss, alphas, fs, its,
             dn)
    got = ops.smo_chunk_lanes(*lanes, _route="cluster")
    _same(got, ops.smo_chunk_lanes(*lanes, _route="one_block_global"))
    assert int(got[2][0]) == 0 and torch.equal(got[1][0], fs[0])
    assert int(got[2][1]) == 0 and bool(got[3][1])
    assert int(got[2][2]) == 97 and bool(got[3][2])
    for l in (1, 2, 3):
        plain = ref.smo_chunk_ref(K, diag, y, masks[l], Cs[l], 1e-3, caps[l],
                                  10**6, wss, alphas[l], fs[l], its[l],
                                  dn[l], update_f=ops.smo_f_update)
        _same(tuple(t[l] for t in got), plain)


@pytest.mark.cuda
def test_cuda_cluster_chunk_lane_alone(cuda):
    """A lane packed with others on the cluster route is bitwise the lane
    alone (one cluster), at the plan's shapes for both launches, and a
    capped solve cut into chunks of 7 iterations equals one chunk."""
    n = 7000
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, 5)
    Cs = [ds.C * (1 + l) for l in range(5)]
    caps = [150, 203, 260, 310, 120]
    packed = ops.smo_chunk_lanes(K, diag, y, masks, Cs, 1e-3, caps, 10**6,
                                 "2", *state, _route="cluster")
    for l in range(5):
        alone = ops.smo_chunk(K, diag, y, masks[l], Cs[l], 1e-3, caps[l],
                              10**6, "2", *(t[l] for t in state),
                              _route="cluster")
        _same(alone, tuple(t[l] for t in packed))
    st = state
    while not bool(st[3].all()):
        st = ops.smo_chunk_lanes(K, diag, y, masks, Cs, 1e-3, caps, 7, "2",
                                 *st, _route="cluster")
    _same(st, packed)


@pytest.mark.cuda
def test_cuda_cluster_chunk_wide_batch(cuda):
    """24 lanes at n=32,544 (the 24-fold CV at the paper's cardinality),
    wider than the multi-block plan places: ``chunk_route`` gives them
    the cluster route, whose lanes are bitwise the global-state kernel's
    after a capped run, and the plain step engine's on lane 0."""
    from repro_torch.kernels.smo_chunk import (_sms, chunk_route,
                                               cluster_capacity,
                                               cluster_plan,
                                               multi_block_plan)
    n, b = 32_544, 24
    m = multi_block_plan(n, b)[0]
    plan = cluster_plan(n, b, cluster_capacity(n), _sms())
    assert m == 0 and plan is not None
    assert chunk_route(n, b, m, plan, _sms()) == "cluster"
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, b)
    caps = [60 + 2 * l for l in range(b)]
    lanes = (K, diag, y, masks, [ds.C] * b, 1e-3, caps, 200, "2", *state)
    before = ops.route_counts()["smo_chunk"]["cluster"]
    got = ops.smo_chunk_lanes(*lanes)
    assert ops.route_counts()["smo_chunk"]["cluster"] == before + 1
    assert got[2].tolist() == caps and bool(got[3].all())
    _same(got, ops.smo_chunk_lanes(*lanes, _route="one_block_global"))
    plain = ref.smo_chunk_ref(K, diag, y, masks[0], ds.C, 1e-3, caps[0], 200,
                              "2", *(t[0] for t in state),
                              update_f=ops.smo_f_update)
    _same(tuple(t[0] for t in got), plain)


@pytest.mark.cuda
def test_cuda_cluster_chunk_refuses_what_it_cannot_place(cuda):
    """A cluster launch the plan cannot place raises, and never falls
    back to another route: 48 lanes at n=32,544 (their state is more than
    the card holds on chip: no plan, and chunk_route keeps them on the
    global-state kernel), a shape the card cannot run b of at once, and a
    shape outside the builds."""
    from repro_torch.kernels.smo_chunk import (_sms, chunk_route,
                                               cluster_capacity,
                                               cluster_plan)
    n, b = 32_544, 48
    cap = cluster_capacity(n)
    assert cluster_plan(n, b, cap, _sms()) is None
    assert chunk_route(n, b, 0, None, _sms()) == "one_block_global"
    ds, K, diag, y, masks, state = _multi_problem(cuda, n, b)
    lanes = (K, diag, y, masks, [ds.C] * b, 1e-3, [10] * b, 20, "2", *state)
    before = ops.route_counts()["smo_chunk"]
    with pytest.raises(ValueError, match="cluster route cannot place"):
        ops.smo_chunk_lanes(*lanes, _route="cluster")
    short = min(cap, key=cap.get)
    with pytest.raises(ValueError, match="cluster route cannot place"):
        ops.smo_chunk_lanes(*lanes, _route="cluster", _cluster=short)
    with pytest.raises(ValueError, match="cluster route cannot place"):
        ops.smo_chunk_lanes(K, diag, y, masks[:2], [ds.C] * 2, 1e-3,
                            [10] * 2, 20, "2", *(t[:2] for t in state),
                            _route="cluster", _cluster=(17, 4))
    assert ops.route_counts()["smo_chunk"] == before


@pytest.mark.cuda
def test_cuda_cluster_builds(cuda):
    """Each build of the cluster kernel exists on the card, with at most
    512 threads a block (a cluster reduces its warps' slots one a lane:
    32 warps at most) and its registers within what that block allows;
    one that does not exist raises."""
    from repro_torch.kernels.smo_chunk import CLUSTER_ROWS, cluster_build
    for rows in CLUSTER_ROWS:
        threads, regs, _ = cluster_build(rows)
        assert 32 <= threads <= 512 and 0 < regs * threads <= 65_536
    with pytest.raises(RuntimeError, match="cluster_build"):
        cluster_build(3)


# --------------------------------------------------------------------------
# alpha seeding's kernels (csrc/seeding.cu): each against its plain version
# run on the CPU on the same inputs; bitwise where the kernel only compares,
# copies and rounds op by op, within the stated bars where it sums
# --------------------------------------------------------------------------

def _box_np(y, C):
    return np.where(y > 0, 0.0, -C), np.where(y > 0, C, 0.0)


def _water_case(n, case, C=2182.0):
    """beta, lo, hi, target for water_fill: a feasible target, one above
    sum(hi) (infeasible: clamped), or every row at a bound."""
    rng = np.random.default_rng(n)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    lo, hi = _box_np(y, C)
    beta = np.clip(rng.normal(size=n) * C / 3, lo, hi)
    target = float(beta.sum() * 0.3)
    if case == "infeasible":
        target = float(hi.sum()) + 5 * C
    elif case == "at_bounds":
        beta = np.where(rng.random(n) < 0.5, lo, hi)
        target = float(beta.sum())
    elif case == "unboxed":   # bounds of every row its own
        lo, hi = -rng.random(n) * C, rng.random(n) * C
        beta = np.clip(rng.normal(size=n) * C / 3, lo, hi)
        target = float(beta.sum() * 0.3)
    return beta, lo, hi, target


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["feasible", "infeasible", "at_bounds"])
@pytest.mark.parametrize("n", [27, 100, 243, 900, 9000, 26048, 32560])
def test_cuda_water_fill_matches_plain(cuda, n, case):
    """Within 1e-12 max(C, 1) of the plain version elementwise, the sum
    equal to the clamped target within n eps max(C, 1); Table 1's sizes,
    and repair_equality's S side at n = 32,560 (streamed from L2 past the
    shared memory's ~9,500 rows)."""
    from repro_torch.kernels.seeding import water_fill
    C = 2182.0
    beta, lo, hi, target = _water_case(n, case, C)
    args = [torch.from_numpy(a) for a in (beta, lo, hi)]
    want = ref.water_fill_ref(*args, target)
    got = water_fill(*(a.to(cuda) for a in args),
                     torch.tensor(target, dtype=torch.float64).to(cuda))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * max(C, 1.0))
    clamped = min(max(target, lo.sum()), hi.sum())
    assert abs(float(got.sum()) - clamped) <= n * np.finfo(float).eps * C
    assert bool((got.cpu() >= args[1]).all() & (got.cpu() <= args[2]).all())


def _sir_case(m, t, rng, ties=True, one_label=False):
    K = rng.random((m, t))
    if ties:   # duplicate instances: equal kernel values in a row
        K[:, 1::3] = K[:, 0:-1:3][:, :K[:, 1::3].shape[1]]
    y_R = np.where(rng.random(m) < 0.5, 1.0, -1.0)
    y_T = np.where(rng.random(t) < (0.9 if one_label else 0.5), 1.0, -1.0)
    if one_label:   # most rows run out of same-label candidates
        y_R[:] = -1.0
    alpha_R = rng.random(m) * 3
    priority = rng.random(t)
    priority[5::7] = priority[0]    # tied priorities
    return [torch.from_numpy(a) for a in (K, y_R, y_T, alpha_R, priority)]


@pytest.mark.cuda
@pytest.mark.parametrize("fallback", ["random", "skip"])
@pytest.mark.parametrize("m,t,one_label", [(27, 27, False), (100, 100, False),
                                           (100, 100, True), (150, 90, True),
                                           (3256, 3256, False),
                                           (40, 6000, True)])
def test_cuda_sir_greedy_bitwise(cuda, m, t, one_label, fallback):
    """SIR's greedy pass equals the plain version bit for bit: tied kernel
    values and priorities (lowest index wins), rows with no same-label
    candidate left, more rows than candidates, both fallbacks; Table 1's
    |R| and n = 32,560's, and a long T beside a few rows."""
    from repro_torch.kernels.seeding import sir_greedy
    args = _sir_case(m, t, np.random.default_rng(m + t), one_label=one_label)
    want = ref.sir_greedy_ref(*args, fallback)
    got = sir_greedy(*(a.to(cuda) for a in args), fallback)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_sir_greedy_past_8192_is_bitwise(cuda):
    """|T| = |R| = 10,853 (adult n = 32,560 at k = 3), K read through the
    index sets from a larger matrix: bitwise the plain version over the
    gathered block, with the random fallback on label-skewed folds."""
    from repro_torch.kernels.seeding import sir_greedy
    rng = np.random.default_rng(10853)
    n, t = 12000, 10853
    K = torch.from_numpy(rng.random((n, n)))
    R = torch.from_numpy(rng.permutation(n)[:t])
    T = torch.from_numpy(rng.permutation(n)[:t])
    y = torch.from_numpy(np.where(rng.random(n) < 0.3, 1.0, -1.0))
    alpha = torch.from_numpy(rng.random(n) * 3)
    priority = torch.from_numpy(rng.random(t))
    args = (y[R], y[T], alpha[R], priority)
    want = ref.sir_greedy_ref(K[R[:, None], T], *args, "random")
    got = sir_greedy(K.to(cuda), *(a.to(cuda) for a in args), "random",
                     R.to(cuda), T.to(cuda))
    assert torch.equal(got.cpu(), want)


def _sir_index_case(case, rng, n=900, t=300):
    """K (n, n) and index sets R, T of t rows each, with tied values, a
    NaN and a -inf entry, or label-skewed folds."""
    K = rng.random((n, n))
    K[:, 1::3] = K[:, 0:-1:3][:, :K[:, 1::3].shape[1]]
    R, T = rng.permutation(n)[:t], rng.permutation(n)[:t]
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    if case == "nan_inf":
        K[R[3], T[7]] = K[R[3], T[20]] = np.nan
        K[R[5], :] = -np.inf
        K[:, T[11]] = np.nan
    elif case == "skewed":
        y[R[: 2 * t // 3]] = -1.0
        y[T] = np.where(np.arange(t) < t // 4, -1.0, 1.0)
    priority = rng.random(t)
    priority[5::7] = priority[0]
    return (torch.from_numpy(K), torch.from_numpy(R), torch.from_numpy(T),
            torch.from_numpy(y), torch.from_numpy(rng.random(n) * 3),
            torch.from_numpy(priority))


@pytest.mark.cuda
@pytest.mark.parametrize("segment", [0, 37])
@pytest.mark.parametrize("fallback", ["random", "skip"])
@pytest.mark.parametrize("case", ["mixed", "nan_inf", "skewed"])
@pytest.mark.parametrize("L", [8, 16, 32, 64])
def test_cuda_sir_greedy_indexed_bitwise(cuda, L, case, fallback, segment):
    """K read through R_idx and T_idx at every list length, in one segment
    or in segments of 37 rows: bitwise the plain version over the
    gathered block (ties, NaN and -inf entries, label-skewed folds that
    rescan and fall back)."""
    from repro_torch.kernels.seeding import sir_greedy
    K, R, T, y, alpha, priority = _sir_index_case(
        case, np.random.default_rng(L))
    args = (y[R], y[T], alpha[R], priority)
    want = ref.sir_greedy_ref(K[R[:, None], T], *args, fallback)
    got = sir_greedy(K.to(cuda), *(a.to(cuda) for a in args), fallback,
                     R.to(cuda), T.to(cuda), _list=L, _segment=segment)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["mixed", "nan_inf", "skewed"])
@pytest.mark.parametrize("L", [8, 64])
def test_cuda_sir_lists_match_the_model(cuda, L, case):
    """The first phase's lists and heads, bitwise the plain model's
    (``ref.sir_lists_ref``), through the indices and over a block."""
    from repro_torch.kernels.seeding import sir_candidate_lists
    K, R, T, y, _, _ = _sir_index_case(case, np.random.default_rng(3 * L))
    want = ref.sir_lists_ref(K[R[:, None], T], y[R], y[T], L)
    got = sir_candidate_lists(K.to(cuda), y[R].to(cuda), y[T].to(cuda), L,
                              R.to(cuda), T.to(cuda))
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    block = K[R[:, None], T].to(cuda)
    got = sir_candidate_lists(block, y[R].to(cuda), y[T].to(cuda), L)
    assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["feasible", "infeasible", "at_bounds",
                                  "unboxed"])
@pytest.mark.parametrize("n", [27, 100, 243, 800, 2048, 9000, 26048, 40000])
def test_cuda_water_fill_levels_equal_the_witness(cuda, n, case):
    """Every levels a round (1-5, and the kernel's own choice) gives the
    one-level witness build's (``water_fill_seq``) result bit for bit, the
    SVM box staged as beta and a bit a row and other bounds staged whole,
    each read from L2 past what shared memory holds; and within 1e-12 C of
    the plain version."""
    from repro_torch.kernels.seeding import water_fill
    args = [torch.from_numpy(a).to(cuda) for a in _water_case(n, case)[:3]]
    target = torch.tensor(_water_case(n, case)[3], dtype=torch.float64,
                          device=cuda)
    want = water_fill(*args, target, _build_name="water_fill_seq")
    for lv in (0, 1, 2, 3, 4, 5):
        got = water_fill(*args, target, _levels=lv)
        assert torch.equal(got.view(torch.int64), want.view(torch.int64)), lv
    plain = ref.water_fill_ref(*(a.cpu() for a in args), target.cpu())
    np.testing.assert_allclose(want.cpu().numpy(), plain.numpy(), rtol=0,
                               atol=1e-12 * 2182.0)


def _ato_state(n, t_n, rng, C=10.0, case="mixed"):
    """A ramp step's inputs: K an RBF matrix, S/T/R masks, alpha with rows
    free and at both bounds, T and R partly active."""
    X = torch.from_numpy(rng.normal(size=(n, 5)))
    K = ref.rbf_kernel_matrix_ref(X, X, 0.2)
    y = torch.from_numpy(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    perm = rng.permutation(n)
    in_T = torch.zeros(n, dtype=torch.bool)
    in_R = torch.zeros(n, dtype=torch.bool)
    in_T[perm[:t_n]] = True
    in_R[perm[t_n:2 * t_n]] = True
    in_S = ~(in_T | in_R)
    u = rng.random(n)
    alpha = np.where(u < 0.3, 0.0, np.where(u < 0.5, C, rng.random(n) * C))
    if case == "bound":          # nf = 0: every row at a bound
        alpha = np.where(u < 0.5, 0.0, C)
    alpha = torch.from_numpy(alpha)
    f = torch.from_numpy(rng.normal(size=n))
    T_act = in_T & torch.from_numpy(rng.random(n) < 0.7)
    R_act = in_R & (alpha > 0)
    return K, y, C, alpha, f, in_S, in_T, T_act, R_act


def _bucket(m, n):
    from repro_torch.core.seeding import _bucket_cap
    return _bucket_cap(m, n)


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_n,case", [(243, 27, "mixed"),
                                        (900, 100, "mixed"),
                                        (900, 100, "bound"),
                                        (2600, 1100, "mixed")])
def test_cuda_ato_system_bitwise(cuda, n, t_n, case):
    """ato_system_lanes' masks, v, w, nf, the compacted working set, lanes,
    yM, B and r0's flag are the plain version's bit for bit (b and rhs[0]
    are sums: rel 1e-13), on one lane (the solo ramp's step); Table 1's
    sizes, nf = 0, and |T| > 1,024."""
    from repro_torch.kernels.seeding import ato_system_lanes
    rng = np.random.default_rng(n + t_n)
    K, y, C, alpha, f, in_S, in_T, T_act, R_act = _ato_state(n, t_n, rng,
                                                             case=case)
    nf0 = int((in_S & (alpha > 0) & (alpha < C)).sum())
    m_cap = _bucket(nf0 + t_n, n)
    b_fb = torch.tensor(0.25, dtype=torch.float64)
    args = (K, y, C, alpha, f, b_fb, in_S, in_T, T_act, R_act, m_cap)
    want = ref.ato_system_ref(*args)
    one = lambda t: t[None].to(cuda)  # noqa: E731
    got = ato_system_lanes(K.to(cuda), y.to(cuda),
                           torch.tensor([C], dtype=torch.float64, device=cuda),
                           one(alpha), one(f), one(b_fb), in_S.to(cuda),
                           in_T.to(cuda), one(T_act), one(R_act), m_cap)
    got = type(got)(*(t[0] for t in got))
    for name in ("train_now", "free", "nf", "v", "w", "idx", "lane", "yM",
                 "B"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    assert torch.equal(got.idx.cpu(), ref.compact_ref(want.free, m_cap))
    torch.testing.assert_close(got.b.cpu(), want.b, rtol=1e-13, atol=0)
    torch.testing.assert_close(got.rhs[0].cpu(), want.rhs[0], rtol=1e-13,
                               atol=1e-13 * float(want.w.abs().sum()))
    if case == "bound":
        assert int(got.nf) == 0 and float(got.B[0, 0]) == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("done", [False, True])
@pytest.mark.parametrize("n", [243, 1000, 32560])
def test_cuda_ato_apply_bitwise(cuda, n, done):
    """ato_apply_lanes' eta, f, T_act, R_act, done and step are the plain
    version's bit for bit, on one lane (the solo ramp's step); a step that
    starts done changes nothing."""
    from repro_torch.kernels.seeding import ato_apply_lanes
    rng = np.random.default_rng(n)
    C, tol = 10.0, 1e-3
    mk = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    alpha = mk(np.where(rng.random(n) < 0.4, 0.0, rng.random(n) * C))
    g = mk(rng.normal(size=n) * np.where(rng.random(n) < 0.1, 0.0, 1.0))
    f, v, Phi = (mk(rng.normal(size=n)) for _ in range(3))
    y = mk(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    train_now = mk(rng.random(n) < 0.8)
    free = train_now & mk(rng.random(n) < 0.3)
    T_act, R_act = mk(rng.random(n) < 0.1), mk(rng.random(n) < 0.1)
    b = torch.tensor(0.1, dtype=torch.float64)
    state = [f, T_act, R_act, torch.tensor(done), torch.tensor(3)]
    card = [s[None].to(cuda) for s in state]
    cpu = [s.clone() for s in state]
    rest = (C, tol, train_now, free)
    one = lambda t: t[None].to(cuda)  # noqa: E731
    eta_c = ato_apply_lanes(one(g), card[0], one(alpha), one(v), one(Phi),
                            y.to(cuda), one(b),
                            torch.tensor([C], dtype=torch.float64,
                                         device=cuda), tol, one(train_now),
                            one(free), card[1], card[2], card[3], card[4], 30)
    eta = ref.ato_apply_ref(g, cpu[0], alpha, v, Phi, y, b, *rest, *cpu[1:],
                            30)
    assert torch.equal(eta_c[0].cpu(), eta)
    for a, w in zip(card, cpu):
        assert torch.equal(a[0].cpu(), w)
    if done:
        for a, w in zip(card, state):
            assert torch.equal(a[0].cpu(), w)


def _seed_problem(cuda, name="heart", n=270, h=1):
    from repro_torch.core.cv import _fold_masks, _transition_idx
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    from repro_torch.svm import kernel_matrix, smo_solve
    ds = make_dataset(name, n_override=n)
    chunks = kfold_chunks(ds.n, 10)
    m = chunks.size
    X = torch.as_tensor(ds.X[:m], device=cuda)
    y = torch.as_tensor(ds.y[:m], dtype=torch.float64, device=cuda)
    K = kernel_matrix(X, X, gamma=ds.gamma)
    masks = torch.as_tensor(_fold_masks(chunks), device=cuda)
    prev = smo_solve(K, y, masks[h - 1], ds.C, torch.zeros_like(y), -y)
    idx = _transition_idx(chunks, h - 1, h, cuda)
    torch.cuda.synchronize()
    return ds, K, y, prev, idx


@pytest.mark.cuda
@pytest.mark.parametrize("name,n", [("heart", 270), ("adult", 1000)])
def test_cuda_seeds_make_no_other_sync(cuda, name, n):
    """Whole ATO, MIR and SIR seeds under set_sync_debug_mode("error"):
    any host sync raises but the three that are wrapped and counted
    (ATO's m_cap once and its stop flag once a chunk, MIR's SVD once)."""
    from repro_torch.core import seeding
    ds, K, y, prev, idx = _seed_problem(cuda, name, n)
    for method in ("ato", "mir", "sir"):   # first calls set up libraries
        seeding.SEEDERS[method](K, y, ds.C, prev, *idx)
    torch.cuda.synchronize()
    for method in ("ato", "mir", "sir"):
        seeding.HOST_SYNCS.update(dict.fromkeys(seeding.HOST_SYNCS, 0))
        torch.cuda.set_sync_debug_mode("error")
        try:
            seeding.SEEDERS[method](K, y, ds.C, prev, *idx)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = dict(seeding.HOST_SYNCS)
        if method == "ato":
            assert syncs["ato_m_cap"] == 1 and syncs["ato_flag"] >= 1
            assert syncs["mir_svd"] == 0
        elif method == "mir":
            assert syncs == {"ato_m_cap": 0, "ato_flag": 0, "mir_svd": 1}
        else:
            assert syncs == dict.fromkeys(syncs, 0)


#: the seeders' bars against the plain versions on the CPU: the card's LU
#: and SVD are other libraries' (tests/test_torch_seeding.py's ATOL)
SEED_ATOL = {"sir": lambda C: 1e-10, "mir": lambda C: 1e-10 * C,
             "ato": lambda C: 1e-12 * C}


@pytest.mark.cuda
@pytest.mark.parametrize("name,n,h", [("heart", 270, 1), ("heart", 270, 4),
                                      ("adult", 1000, 1)])
def test_cuda_seeds_match_plain(cuda, name, n, h):
    """Each seed through the kernels within the seeders' bars of the same
    seed through the plain versions on the CPU, from the same prev."""
    from repro_torch.core import seeding
    from repro_torch.svm.engine import SMOResult
    ds, K, y, prev, idx = _seed_problem(cuda, name, n, h)
    prev_c = SMOResult(*(t.cpu() for t in prev))
    for method in ("ato", "mir", "sir"):
        got = seeding.SEEDERS[method](K, y, ds.C, prev, *idx).cpu()
        want = seeding.SEEDERS[method](K.cpu(), y.cpu(), ds.C, prev_c,
                                       *(i.cpu() for i in idx))
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=SEED_ATOL[method](ds.C))


@pytest.mark.cuda
def test_cuda_ato_ramp_chunks_bitwise(cuda):
    """The chunked ramp gives the same seed at chunk sizes 1, 4 and 30 on
    the card: steps past the stop flag are the identity."""
    from repro_torch.core import seeding
    ds, K, y, prev, idx = _seed_problem(cuda, "heart", 270, 1)
    seeds = [seeding.ato_seed(K, y, ds.C, prev, *idx, chunk=c)
             for c in (1, 4, 30)]
    assert torch.equal(seeds[0], seeds[1]) and torch.equal(seeds[0],
                                                           seeds[2])


# --------------------------------------------------------------------------
# the Study slice's kernels: ATO's step over a row of lanes, the rows-of-n
# f-update, and the LOO spills; each against its plain version on the CPU
# and, over lanes, against the one-lane kernel on every lane
# --------------------------------------------------------------------------

def _lanes_state(n, t_n, C_row, seed):
    """A row of lanes sharing K, y and the transition, each with its own
    C, alpha, f and active sets (``_ato_state`` per lane)."""
    # one seed for every lane: the same K, y and masks, alpha scaled by C
    per = [_ato_state(n, t_n, np.random.default_rng(seed), C=C)
           for C in C_row]
    K, y, _, _, _, in_S, in_T, _, _ = per[0]
    stack = lambda i: torch.stack([p[i] for p in per])  # noqa: E731
    alpha, f, T_act, R_act = stack(3), stack(4), stack(7), stack(8)
    Cs = torch.tensor(C_row, dtype=torch.float64)
    nf0 = max(int((in_S & (a > 0) & (a < C)).sum())
              for a, C in zip(alpha, C_row))
    return (K, y, Cs, alpha, f, torch.linspace(-0.5, 0.5, len(C_row),
                                               dtype=torch.float64),
            in_S, in_T, T_act, R_act, _bucket(nf0 + t_n, n))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t_n", [(243, 27), (900, 100), (2600, 1100)])
def test_cuda_ato_system_lanes_bitwise(cuda, n, t_n):
    """Over three lanes (C = 0.1, 10, 1000): every exact output is the
    plain version's bit for bit (b and rhs[0] within rel 1e-13), and every
    lane, sums included, is what a one-lane launch on its slice gives it,
    bit for bit (rhs[1:] is left to the caller)."""
    from repro_torch.kernels.seeding import ato_system_lanes
    args = _lanes_state(n, t_n, [0.1, 10.0, 1000.0], n)
    want = ref.ato_system_lanes_ref(*args)
    dev = [a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    got = ato_system_lanes(*dev)
    for name in ("train_now", "free", "nf", "v", "w", "idx", "lane", "yM",
                 "B"):
        assert torch.equal(getattr(got, name).cpu(), getattr(want, name)), \
            name
    torch.testing.assert_close(got.b.cpu(), want.b, rtol=1e-13, atol=0)
    torch.testing.assert_close(got.rhs[:, 0].cpu(), want.rhs[:, 0],
                               rtol=1e-13, atol=1e-13 * float(
                                   want.w.abs().sum()))
    K, y, Cs, alpha, f, bfb, in_S, in_T, T_act, R_act, m_cap = dev
    for lane in range(3):
        sl = slice(lane, lane + 1)
        solo = ato_system_lanes(K, y, Cs[sl], alpha[sl], f[sl], bfb[sl],
                                in_S, in_T, T_act[sl], R_act[sl], m_cap)
        for name in solo._fields[:-1]:   # rhs[1:] is the caller's
            assert torch.equal(getattr(solo, name)[0],
                               getattr(got, name)[lane]), (lane, name)
        assert torch.equal(solo.rhs[0, 0], got.rhs[lane, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [243, 1000, 32560])
def test_cuda_ato_apply_lanes_bitwise(cuda, n):
    """Over three lanes, one of them done: eta, f, T_act, R_act, done and
    step are the plain version's bit for bit and each lane's is what a
    one-lane launch on its slice gives it; the done lane changes
    nothing."""
    from repro_torch.kernels.seeding import ato_apply_lanes
    rng = np.random.default_rng(n)
    L, tol = 3, 1e-3
    Cs = torch.tensor([0.1, 10.0, 1000.0], dtype=torch.float64)
    mk = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    alpha = mk(np.where(rng.random((L, n)) < 0.4, 0.0,
                        rng.random((L, n)))) * Cs[:, None]
    g = mk(rng.normal(size=(L, n)) * np.where(rng.random((L, n)) < 0.1, 0.0,
                                              1.0))
    f, v, Phi = (mk(rng.normal(size=(L, n))) for _ in range(3))
    y = mk(np.where(rng.random(n) < 0.5, 1.0, -1.0))
    train_now = mk(rng.random((L, n)) < 0.8)
    free = train_now & mk(rng.random((L, n)) < 0.3)
    T_act, R_act = mk(rng.random((L, n)) < 0.1), mk(rng.random((L, n)) < 0.1)
    b = torch.tensor([0.1, -0.2, 0.3], dtype=torch.float64)
    state = [f, T_act, R_act, torch.tensor([False, True, False]),
             torch.tensor([3, 5, 29])]
    card = [s.to(cuda) for s in state]
    solo = [s.to(cuda) for s in state]
    cpu = [s.clone() for s in state]
    eta_c = ato_apply_lanes(g.to(cuda), card[0], alpha.to(cuda), v.to(cuda),
                            Phi.to(cuda), y.to(cuda), b.to(cuda), Cs.to(cuda),
                            tol, train_now.to(cuda), free.to(cuda), *card[1:],
                            30)
    eta = ref.ato_apply_lanes_ref(g, cpu[0], alpha, v, Phi, y, b, Cs, tol,
                                  train_now, free, *cpu[1:], 30)
    assert torch.equal(eta_c.cpu(), eta)
    for a, w in zip(card, cpu):
        assert torch.equal(a.cpu(), w)
    for lane in range(L):
        sl = slice(lane, lane + 1)
        e = ato_apply_lanes(g[sl].to(cuda), solo[0][sl], alpha[sl].to(cuda),
                            v[sl].to(cuda), Phi[sl].to(cuda), y.to(cuda),
                            b[sl].to(cuda), Cs[sl].to(cuda), tol,
                            train_now[sl].to(cuda), free[sl].to(cuda),
                            solo[1][sl], solo[2][sl], solo[3][sl],
                            solo[4][sl], 30)
        assert torch.equal(e[0], eta_c[lane])
    for a, w in zip(card, solo):
        assert torch.equal(a, w)
    assert float(eta_c[1]) == 0.0
    for a, w in zip(card, state):
        assert torch.equal(a[1].cpu(), w[1])


def _bits(t):
    """A tensor's bits (float64 as int64), for bitwise comparisons."""
    return t.view(torch.int64) if t.dtype == torch.float64 else t


class _RampWitness:
    """Wraps the ramp's two kernels in ``core.seeding``: each carried
    ``ato_system_lanes`` call is held, field by field and bit for bit, to
    the compact route (today's kernel) on the same state, and each fused
    ``ato_apply_lanes`` to the split route, then ``smo_f_update`` and the
    clamp, on copies of its inputs (alpha, f, T_act, R_act, done, step
    and eta)."""

    def __enter__(self):
        from repro_torch.core import seeding as cs
        from repro_torch.kernels import seeding as ks
        from repro_torch.kernels.smo_update import smo_f_update
        self.cs, self.saved = cs, (cs.ato_system_lanes, cs.ato_apply_lanes)
        self.steps = {"carried": 0, "fused": 0}

        def system(*a, out=None, _route="compact"):
            if _route != "carried":
                return ks.ato_system_lanes(*a, out=out, _route=_route)
            want = ks.ato_system_lanes(*a)
            got = ks.ato_system_lanes(*a, out=out, _route="carried")
            for key in ref.ATO_CARRIED + ("B",):
                assert torch.equal(_bits(getattr(got, key)),
                                   _bits(getattr(want, key))), key
            assert torch.equal(_bits(got.rhs[:, 0]), _bits(want.rhs[:, 0]))
            self.steps["carried"] += 1
            return got

        def apply(g, f, alpha, v, Phi, y, b, Cs, tol, tn, fr, T_act, R_act,
                  done, step, max_steps, *, carry=None):
            sp = [t.clone() for t in (f, alpha, v, b, tn, fr, T_act, R_act,
                                      done, step)]
            eta_s = ks.ato_apply_lanes(g, sp[0], sp[1], sp[2], Phi, y, sp[3],
                                       Cs, tol, *sp[4:], max_steps)
            a_s = torch.clamp(smo_f_update(sp[1], sp[2], Phi, eta_s),
                              torch.zeros_like(Cs)[:, None], Cs[:, None])
            eta = ks.ato_apply_lanes(g, f, alpha, v, Phi, y, b, Cs, tol, tn,
                                     fr, T_act, R_act, done, step, max_steps,
                                     carry=carry)
            for got, want in ((eta, eta_s), (alpha, a_s), (f, sp[0]),
                              (T_act, sp[6]), (R_act, sp[7]), (done, sp[8]),
                              (step, sp[9])):
                assert torch.equal(_bits(got), _bits(want))
            self.steps["fused"] += 1
            return eta

        cs.ato_system_lanes, cs.ato_apply_lanes = system, apply
        return self

    def __exit__(self, *exc):
        self.cs.ato_system_lanes, self.cs.ato_apply_lanes = self.saved


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [1, 3])
@pytest.mark.parametrize("name,n", [("heart", 270), ("adult", 1000)])
def test_cuda_ato_carried_route_is_the_compact_route(cuda, name, n, lanes):
    """Over every step of a ramp (fold 0 -> 1; one lane, the solo seed, or
    three, the C row at 0.01 / 1 / 100 x C): the carried route's working
    set, B and rhs[0] are the compact route's on the same state, bit for
    bit, and the fused apply is the split apply, ``smo_f_update`` and the
    clamp, bit for bit; the seed is the plain version's within the ATO bar
    on the CPU. Heart's ramps run many carried steps."""
    from repro_torch.core import seeding
    from repro_torch.svm import smo_solve
    from repro_torch.svm.engine import SMOResult
    ds, K, y, prev, idx = _seed_problem(cuda, name, n)
    if lanes == 1:
        run = lambda: seeding.ato_seed(K, y, ds.C, prev, *idx)  # noqa: E731
        cpu = lambda: seeding.ato_seed(  # noqa: E731
            K.cpu(), y.cpu(), ds.C, SMOResult(*(t.cpu() for t in prev)),
            *(i.cpu() for i in idx))
    else:
        from repro_torch.core.cv import _fold_masks
        from repro_torch.data.svm_suite import kfold_chunks
        Cs = [c * ds.C for c in (0.01, 1.0, 100.0)]
        mask = torch.as_tensor(_fold_masks(kfold_chunks(ds.n, 10))[0],
                               device=cuda)
        sols = [smo_solve(K, y, mask, C, torch.zeros_like(y), -y)
                for C in Cs]
        prev = SMOResult(*(torch.stack([torch.as_tensor(getattr(r, k))
                                        for r in sols])
                           for k in SMOResult._fields))
        run = lambda: seeding.ato_seed_batch(  # noqa: E731
            K, y, Cs, prev, *idx, bucket_by_lane=False)
        cpu = lambda: seeding.ato_seed_batch(  # noqa: E731
            K.cpu(), y.cpu(), Cs, SMOResult(*(t.cpu() for t in prev)),
            *(i.cpu() for i in idx), bucket_by_lane=False)
    with _RampWitness() as w:
        got = run()
    torch.cuda.synchronize()
    assert w.steps["fused"] >= 1
    if name == "heart":
        assert w.steps["carried"] >= 10
    np.testing.assert_allclose(got.cpu().numpy(), cpu().numpy(), rtol=0,
                               atol=1e-12 * 100.0 * ds.C)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [243, 1000, 1100, 2600])
def test_cuda_ato_fused_apply_bitwise(cuda, n):
    """The fused apply over three lanes (C = 0.1, 10, 1000; one done): its
    alpha, f, T_act, R_act, done, step and eta are the split apply's, then
    ``smo_f_update``'s and the clamp's, bit for bit, and every field it
    hands the next step is the compact route's on the state it leaves
    (the done lane's stays); the plain fused apply on the CPU gives the
    same bits. n = 1,100 and 2,600 take the rows-from-memory build."""
    from repro_torch.kernels.seeding import ato_system_lanes
    args = _lanes_state(n, n // 10, [0.1, 10.0, 1000.0], n + 1)
    K, y, Cs, alpha, f, bfb, in_S, in_T, T_act, R_act, m_cap = [
        a.to(cuda) if isinstance(a, torch.Tensor) else a for a in args]
    s = ato_system_lanes(K, y, Cs, alpha, f, bfb, in_S, in_T, T_act, R_act,
                         m_cap)
    rng = np.random.default_rng(n)
    g = torch.from_numpy(rng.normal(size=(3, n)) * np.where(
        rng.random((3, n)) < 0.1, 0.0, 1.0)).to(cuda)
    Phi = torch.where(s.free, torch.from_numpy(
        rng.normal(size=(3, n))).to(cuda), 0.0)
    done = torch.tensor([False, True, False], device=cuda)
    step = torch.tensor([3, 5, 29], device=cuda)
    state = [alpha, f, T_act, R_act, done, step]
    with _RampWitness() as w:
        from repro_torch.core import seeding as cs
        fused = [t.clone() for t in state]
        sf = ref.AtoSystem(*(t.clone() for t in s))
        eta = cs.ato_apply_lanes(g, fused[1], fused[0], sf.v, Phi, y, sf.b,
                                 Cs, 1e-3, sf.train_now, sf.free,
                                 *fused[2:], 30,
                                 carry=ref.AtoCarry(K, in_S, in_T, bfb, sf))
    assert w.steps["fused"] == 1
    nxt = ato_system_lanes(K, y, Cs, *fused[:2], bfb, in_S, in_T,
                           *fused[2:4], m_cap)
    for key in ref.ATO_CARRIED:
        want = getattr(nxt, key).clone()
        want[1] = getattr(s, key)[1]
        assert torch.equal(_bits(getattr(sf, key)), _bits(want)), key
    assert torch.equal(_bits(sf.rhs[[0, 2], 0]), _bits(nxt.rhs[[0, 2], 0]))
    cpu_state = [t.cpu() for t in state]
    cpu_s = ref.AtoSystem(*(t.cpu() for t in s))
    eta_c = ref.ato_apply_lanes_ref(
        g.cpu(), cpu_state[1], cpu_state[0], cpu_s.v, Phi.cpu(), y.cpu(),
        cpu_s.b, Cs.cpu(), 1e-3, cpu_s.train_now, cpu_s.free,
        *cpu_state[2:], 30, ref.AtoCarry(K.cpu(), in_S.cpu(), in_T.cpu(),
                                         bfb.cpu(), cpu_s))
    assert torch.equal(_bits(eta.cpu()), _bits(eta_c))
    for a, c in zip(fused, cpu_state):
        assert torch.equal(_bits(a.cpu()), _bits(c))
    for key in ("train_now", "free", "nf", "v", "w", "idx", "lane", "yM",
                "lam"):
        assert torch.equal(_bits(getattr(sf, key).cpu()),
                           _bits(getattr(cpu_s, key))), key


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n", [(1, 1000), (3, 1000), (5, 32560)])
def test_cuda_f_update_rows_bitwise(cuda, rows, n):
    """smo_f_update over rows: each row is the CPU addcmul's bit for bit,
    and smo_f_update's on that row alone with its delta."""
    from repro_torch.kernels.smo_update import smo_f_update
    rng = np.random.default_rng(rows * n)
    f, Ki, Kj = (torch.from_numpy(rng.normal(size=(rows, n)))
                 for _ in range(3))
    d = torch.from_numpy(rng.normal(size=rows))
    got = smo_f_update(f.to(cuda), Ki.to(cuda), Kj.to(cuda), d.to(cuda))
    assert torch.equal(got.cpu(), ref.smo_f_update_ref(f, Ki, Kj,
                                                       d[:, None]))
    for r in range(rows):
        assert torch.equal(got[r], smo_f_update(
            f[r].to(cuda), Ki[r].to(cuda), Kj[r].to(cuda), d[r].to(cuda)))


def _spill_case(n, seed, C=2182.0):
    rng = np.random.default_rng(seed)
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    lo, hi = _box_np(y, C)
    alpha = np.where(rng.random(n) < 0.3, 0.0,
                     np.where(rng.random(n) < 0.3, C, rng.random(n) * C))
    beta = y * alpha
    t = int(rng.integers(n))
    resid = beta[t]
    beta[t], lo[t], hi[t] = 0.0, 0.0, 0.0
    free0 = (alpha > 0) & (alpha < C)
    free0[t] = False
    return [torch.from_numpy(a) for a in (beta, lo, hi, free0)] + [
        torch.tensor(resid)], t, rng


@pytest.mark.cuda
@pytest.mark.parametrize("n", [27, 270, 1000, 9000])
def test_cuda_avg_spill_matches_plain(cuda, n):
    """The 8 rounds in one block: within 1e-12 max(C, 1) of the plain
    version (the count is exact, the adds sum in the block's order)."""
    from repro_torch.kernels.seeding import avg_spill
    C = 2182.0
    args, _, _ = _spill_case(n, n, C)
    want = ref.avg_spill_ref(*args)
    got = avg_spill(*(a.to(cuda) for a in args))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * max(C, 1.0))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [27, 270, 1000, 12000])
def test_cuda_top_spill_equals_plain(cuda, n):
    """The walk equals the plain version value for value (torch.equal):
    tied similarities in the order, a residual that runs out early, and
    past shared memory's ~9,500 rows (gathered from global memory)."""
    from repro_torch.kernels.seeding import top_spill
    args, t, rng = _spill_case(n, n + 1)
    beta, lo, hi, _, resid = args
    sim = torch.from_numpy(rng.random(n))
    sim[1::4] = sim[0]            # ties: stable order
    sim[t] = -np.inf
    order = torch.argsort(-sim, stable=True)
    want = ref.top_spill_ref(order, beta, lo, hi, resid)
    got = top_spill(order.to(cuda), beta.to(cuda), lo.to(cuda), hi.to(cuda),
                    resid.to(cuda))
    assert torch.equal(got.cpu(), want)


LOO_AVG_CASES = ("random", "t0", "tlast", "neg", "long", "never", "nan",
                 "huge")
LOO_TOP_CASES = ("ties", "t0", "tlast", "neg", "first", "long", "never")


def _loo_inputs(n, case, C=2182.0):
    """(col, y, alpha, C, t) in numpy for the LOO spills' fused routes:
    col is K[:, t]. ``random`` / ``ties``: mixed labels and alpha (at 0,
    at C, inside), t drawn, and for ties ``_spill_case``'s tied
    similarities with -0.0 and +0.0 in the column; ``t0`` / ``tlast``: t =
    0 / n - 1; ``neg``: a negative residual; ``first``: the most similar
    row takes the whole residual; ``never``: every other row is at the
    bound on the residual's side (no room: AVG has no free row, TOP walks
    every row and keeps the residual); ``long``: as ``never`` but every
    seventh row free with room 0.05 C (TOP walks ~12 of them, some 80
    rows); ``nan``: one alpha NaN, ``huge``: C = 1e300 (AVG's rounds keep
    the clamp's NaN tests)."""
    rng = np.random.default_rng(n + len(case))
    C = 1e300 if case == "huge" else C
    y = np.where(rng.random(n) < 0.5, 1.0, -1.0)
    u = rng.random(n)
    alpha = np.where(u < 0.3, 0.0, np.where(u < 0.5, C, rng.random(n) * C))
    col = rng.random(n)
    t = {"t0": 0, "tlast": n - 1}.get(case, int(rng.integers(n)))
    y[t], alpha[t] = (-1.0 if case == "neg" else 1.0), 0.6 * C
    if case == "ties":
        col[1::4] = col[0]
        col[2::9] = 0.0
        col[3::9] = -0.0
    if case == "first":
        j = (t + 1) % n
        col[j] = 2.0
        y[j], alpha[j] = 1.0, 0.0
    if case == "nan":
        alpha[(t + 2) % n] = np.nan
    if case in ("never", "long"):
        alpha = np.where(y > 0, C, 0.0)
        if case == "long":
            alpha[::7] = np.where(y[::7] > 0, 0.95 * C, 0.05 * C)
        y[t], alpha[t] = 1.0, 0.6 * C
    return col, y, alpha, C, t


def _loo_device(cuda, n, case):
    """The inputs on the card, K (n, n) random but for its column t, and
    on the CPU."""
    col, y, alpha, C, t = _loo_inputs(n, case)
    g = torch.Generator(device=cuda).manual_seed(n)
    K = torch.rand((n, n), generator=g, dtype=torch.float64, device=cuda)
    K[:, t] = torch.from_numpy(col).to(cuda)
    cpu = [torch.from_numpy(a) for a in (col, y, alpha)]
    return K, cpu[1].to(cuda), cpu[2].to(cuda), C, t, cpu


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOO_AVG_CASES)
@pytest.mark.parametrize("n", [27, 270, 1000, 9000, 40000])
def test_cuda_avg_spill_fused_is_split(cuda, n, case):
    """avg_spill's fused route (prologue and 8 rounds in one launch) is
    the split kernel on the plain prologue bit for bit, within 1e-12
    max(C, 1) of the plain version, and writes _box's lo and hi (row t
    closed) bit for bit: rows in registers (n <= 4,096), in shared memory
    (9,000) and in L2 (40,000); a NaN and a C of 1e300 take the rounds
    with the clamp's NaN tests."""
    from repro_torch.kernels.seeding import avg_spill, avg_spill_loo
    _, y_np, a_np, C, t = _loo_inputs(n, case)
    yc, ac = torch.from_numpy(y_np), torch.from_numpy(a_np)
    y, alpha = yc.to(cuda), ac.to(cuda)
    before = ops.route_counts()["avg_spill"]
    beta, lo, hi = avg_spill_loo(y, alpha, C, t)
    after = ops.route_counts()["avg_spill"]
    assert after == {"fused": before["fused"] + 1, "split": before["split"]}
    b0, resid, lo0, hi0, free0 = ref.loo_start_ref(y, alpha, C, t)
    split = avg_spill(b0, lo0, hi0, free0, resid)
    assert torch.equal(_bits(beta.cpu()), _bits(split.cpu()))
    _, _, lo_c, hi_c, _ = ref.loo_start_ref(yc, ac, C, t)
    assert torch.equal(_bits(lo.cpu()), _bits(lo_c))
    assert torch.equal(_bits(hi.cpu()), _bits(hi_c))
    want, _, _ = ref.avg_spill_loo_ref(yc, ac, C, t)
    np.testing.assert_allclose(beta.cpu().numpy(), want.numpy(), rtol=0,
                               atol=1e-12 * max(C, 1.0))


def _top_plain(col, y, alpha, C, t):
    """top_spill_loo's plain version from column t alone: (beta, lo, hi)."""
    b0, resid, lo, hi, _ = ref.loo_start_ref(y, alpha, C, t)
    return ref.top_spill_ref(ref.loo_order_ref(col, t), b0, lo, hi,
                             resid), lo, hi


def _walk_length(col, y, alpha, C, t):
    """The rows TOP's walk visits: until the residual is 0 or the order
    (but its last row) runs out."""
    beta, resid, lo, hi, _ = ref.loo_start_ref(y, alpha, C, t)
    order = ref.loo_order_ref(col, t)[:-1].tolist()
    b, l, h, r = beta.tolist(), lo.tolist(), hi.tolist(), float(resid)
    k = 0
    for j in order:
        if r == 0.0:
            break
        room = h[j] - b[j] if r >= 0 else l[j] - b[j]
        r -= min(max(r, min(room, 0.0)), max(room, 0.0))
        k += 1
    return k


@pytest.mark.cuda
@pytest.mark.parametrize("case", LOO_TOP_CASES)
@pytest.mark.parametrize("n", [27, 270, 1000, 9000, 12000])
def test_cuda_top_spill_fused_equals_plain(cuda, n, case):
    """top_spill's fused route (prologue, the order of column t found on
    chip, the walk; one launch) equals the plain version (the glue, a
    stable argsort, top_spill_ref) value for value, writes _box's lo and
    hi bit for bit, and adds its walk's length to ``top_spill_walks``."""
    from repro_torch.kernels import seeding as ks
    K, y, alpha, C, t, (col, yc, ac) = _loo_device(cuda, n, case)
    before = ops.route_counts()["top_spill"]
    ks.reset_top_spill_walks()
    beta, lo, hi = ks.top_spill_loo(K, y, alpha, C, t)
    after = ops.route_counts()["top_spill"]
    assert after == {"fused": before["fused"] + 1, "split": before["split"]}
    want, lo_c, hi_c = _top_plain(col, yc, ac, C, t)
    assert torch.equal(beta.cpu(), want)
    assert torch.equal(_bits(lo.cpu()), _bits(lo_c))
    assert torch.equal(_bits(hi.cpu()), _bits(hi_c))
    walks = ks.top_spill_walks()
    k = _walk_length(col, yc, ac, C, t)
    assert walks["seeds"] == 1 and walks["rows"] == walks["longest"] == k
    if case == "first":
        assert k == 1
    if case == "never":
        assert k == n - 1


@pytest.mark.cuda
def test_cuda_top_spill_past_fused_size_takes_split(cuda):
    """Past the rows the fused route's lists fit in, top_spill_loo takes
    the split route (the plain prologue and argsort, then the walk
    kernel), counted, and equals the plain version."""
    from repro_torch.kernels import seeding as ks
    n = ks.TOP_FUSED_MAX_ROWS + 3616
    K, y, alpha, C, t, (col, yc, ac) = _loo_device(cuda, n, "ties")
    before = ops.route_counts()["top_spill"]
    beta, lo, hi = ks.top_spill_loo(K, y, alpha, C, t)
    after = ops.route_counts()["top_spill"]
    assert after == {"fused": before["fused"], "split": before["split"] + 1}
    want, lo_c, hi_c = _top_plain(col, yc, ac, C, t)
    assert torch.equal(beta.cpu(), want)
    assert torch.equal(_bits(lo.cpu()), _bits(lo_c))
    assert torch.equal(_bits(hi.cpu()), _bits(hi_c))


def _row_problem(cuda, name="heart", n=270, h=1):
    """The ATO C row (0.01, 1, 100 x C) at fold h-1, solved by the batched
    solve, and the h-1 -> h index sets."""
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks
    from repro_torch.svm import smo_solve_batched
    ds, K, y, _, idx = _seed_problem(cuda, name, n, h)
    masks = torch.as_tensor(_fold_masks(kfold_chunks(ds.n, 10)), device=cuda)
    Cs = [s * ds.C for s in (0.01, 1.0, 100.0)]
    m = y.shape[0]
    prev = smo_solve_batched(K, y, masks[h - 1].repeat(3, 1), Cs,
                             torch.zeros((3, m), dtype=torch.float64,
                                         device=cuda), -y.repeat(3, 1))
    return ds, K, y, Cs, prev, idx


@pytest.mark.cuda
@pytest.mark.parametrize("bucket_by_lane", [True, False])
@pytest.mark.parametrize("name,n", [("heart", 270), ("adult", 1000)])
def test_cuda_ato_seed_batch_matches_solo(cuda, name, n, bucket_by_lane):
    """Each lane of the batched ramp within the ATO bar (1e-12 C) of the
    solo ato_seed on the card and of the batched ramp's plain version on
    the CPU; the chunk size does not change the seeds."""
    from repro_torch.core import seeding
    from repro_torch.svm.engine import SMOResult
    ds, K, y, Cs, prev, idx = _row_problem(cuda, name, n)
    got = seeding.ato_seed_batch(K, y, Cs, prev, *idx,
                                 bucket_by_lane=bucket_by_lane)
    cpu = seeding.ato_seed_batch(K.cpu(), y.cpu(), Cs,
                                 SMOResult(*(t.cpu() for t in prev)),
                                 *(i.cpu() for i in idx),
                                 bucket_by_lane=bucket_by_lane)
    for lane, C in enumerate(Cs):
        solo = seeding.ato_seed(K, y, C, SMOResult(*(t[lane] for t in prev)),
                                *idx)
        np.testing.assert_allclose(got[lane].cpu().numpy(),
                                   solo.cpu().numpy(), rtol=0, atol=1e-12 * C)
        np.testing.assert_allclose(got[lane].cpu().numpy(),
                                   cpu[lane].numpy(), rtol=0, atol=1e-12 * C)
    again = seeding.ato_seed_batch(K, y, Cs, prev, *idx,
                                   bucket_by_lane=bucket_by_lane, chunk=30)
    assert torch.equal(again, got)


@pytest.mark.cuda
def test_cuda_study_transforms_make_no_other_sync(cuda):
    """scale_C, loo_avg, loo_top and ato_seed_batch under
    set_sync_debug_mode("error"): no host sync but the batched ramp's
    counted reads (the free counts once, the stop flags once a chunk)."""
    from repro_torch.core import seeding
    ds, K, y, Cs, prev, idx = _row_problem(cuda, "adult", 1000)
    lane0 = type(prev)(*(t[1] for t in prev))
    mask = torch.ones_like(y, dtype=torch.bool).index_fill_(0, idx[2], False)
    runs = {
        "scale_C": lambda: seeding.TRANSFORMS["scale_C"](
            K, y, 4 * ds.C, lane0, C_old=ds.C, train_mask=mask),
        "loo_avg": lambda: seeding.TRANSFORMS["loo_avg"](K, y, ds.C, lane0,
                                                         t=7),
        "loo_top": lambda: seeding.TRANSFORMS["loo_top"](K, y, ds.C, lane0,
                                                         t=7),
        "ato_seed_batch": lambda: seeding.ato_seed_batch(K, y, Cs, prev,
                                                         *idx)}
    for name, run in runs.items():
        run()                       # first calls set up libraries
        torch.cuda.synchronize()
        seeding.HOST_SYNCS.update(dict.fromkeys(seeding.HOST_SYNCS, 0))
        torch.cuda.set_sync_debug_mode("error")
        try:
            run()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        syncs = dict(seeding.HOST_SYNCS)
        if name == "ato_seed_batch":
            assert syncs["ato_m_cap"] == 1 and syncs["ato_flag"] >= 1
            assert syncs["mir_svd"] == 0
        else:
            assert syncs == dict.fromkeys(syncs, 0), name


@pytest.mark.cuda
def test_cuda_grid_and_loo_run_on_the_card(cuda):
    """run_grid (cross-gamma, one kernel resident) and run_loo (AVG fan-out
    and the SIR chain) on the card: every cell and round converges, and
    the grid's cell equals run_cv on it."""
    from repro_torch.core.cv import run_cv, run_loo
    from repro_torch.core.grid import run_grid
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("adult", n_override=300)
    rep = run_grid(ds, [ds.C, 4 * ds.C], [ds.gamma, 2 * ds.gamma], k=5,
                   max_resident=1)
    assert all(c.converged for c in rep.cells)
    assert rep.resident["peak_resident"] == 1
    cv = run_cv(ds, k=5, method="sir")
    assert rep.cells[0].iterations == cv.total_iterations
    assert rep.cells[0].acc_correct == sum(f.acc_correct for f in cv.folds)
    for method in ("avg", "sir"):
        out = run_loo(ds, method=method, rounds=8)
        assert out["converged"] and out["rounds"] == 8


# --------------------------------------------------------------------------
# chunks over lanes that each carry their own operands (shrinking's compact
# lanes): one launch, each lane bitwise its own launch on its own source
# --------------------------------------------------------------------------

def _compact_lanes(cuda, n, cap, b, stream=False, seed=0):
    """b lanes over compact subsets of adult's first n rows: each lane's
    own rows (cap of them, sorted), its K or X, labels, a mask holding out
    a fifth, a cold state."""
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels.smo_chunk import seq_norms
    ds = make_dataset("adult", n_override=n)
    X = torch.from_numpy(ds.X).to(cuda)
    y = torch.from_numpy(ds.y).to(cuda, torch.float64)
    g = torch.Generator().manual_seed(seed)
    idx = [torch.sort(torch.randperm(n, generator=g)[:cap]).values.to(cuda)
           for _ in range(b)]
    ys = torch.stack([y[i] for i in idx])
    masks = torch.stack([torch.rand(cap, generator=g) >= 0.2
                         for _ in idx]).to(cuda)
    state = (torch.zeros((b, cap), dtype=torch.float64, device=cuda), -ys,
             torch.zeros(b, dtype=torch.int64, device=cuda),
             torch.zeros(b, dtype=torch.bool, device=cuda))
    if stream:
        Xs = torch.stack([X[i] for i in idx])
        return ds, (Xs, torch.sum(Xs * Xs, -1), seq_norms(Xs)), ys, masks, \
            state
    K = ops.rbf_kernel_matrix(X, X, ds.gamma)
    Ks = torch.stack([K[i[:, None], i[None, :]] for i in idx])
    return ds, (Ks, torch.diagonal(Ks, dim1=1, dim2=2).contiguous()), ys, \
        masks, state


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["one_block", "multi_block", "cluster",
                                   "one_block_global"])
@pytest.mark.parametrize("wss", ["2", "1"])
def test_cuda_chunk_sources_bitwise_solo_and_plain(cuda, route, wss):
    """Three lanes with their own compact K (1,024 of adult's 3,000 rows)
    in ONE launch on each route: each lane bitwise its own launch over its
    own K on that route, and the plain step loop; a done lane untouched;
    the launch counted on ``smo_chunk_sources``'s route."""
    ds, (Ks, diags), ys, masks, state = _compact_lanes(cuda, 3000, 1024, 3)
    caps = [300, 220, 300]
    before = ops.route_counts()["smo_chunk_sources"][route]
    got = ops.smo_chunk_sources(Ks, diags, ys, masks, [ds.C] * 3, 1e-3, caps,
                                301, wss, *state, _route=route)
    assert ops.route_counts()["smo_chunk_sources"][route] == before + 1
    assert got[2].tolist() == caps
    plain = ref.smo_chunk_sources_ref(Ks, diags, ys, masks, [ds.C] * 3, 1e-3,
                                      caps, 301, wss, *state,
                                      update_f=ops.smo_f_update)
    for l in range(3):
        solo = ops.smo_chunk_lanes(Ks[l], diags[l], ys[l], masks[l:l + 1],
                                   [ds.C], 1e-3, [caps[l]], 301, wss,
                                   *(t[l:l + 1] for t in state),
                                   _route=route)
        for a, s, p in zip(got, solo, plain):
            assert torch.equal(a[l], s[0])
            assert torch.equal(a[l], p[l])
    # a lane that arrives done passes through
    frozen = list(state)
    frozen[3] = torch.tensor([False, True, False], device=cuda)
    out = ops.smo_chunk_sources(Ks, diags, ys, masks, [ds.C] * 3, 1e-3, caps,
                                301, wss, *frozen, _route=route)
    assert torch.equal(out[0][1], state[0][1])
    assert int(out[2][1]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["one_block", "multi_block", "cluster",
                                   "one_block_global"])
def test_cuda_shared_launch_is_per_lane_launch_of_copies(cuda, route):
    """A shared-operand launch (strides 0) is bitwise the per-lane launch
    over copies of the same K: the stride is the only difference."""
    ds, K, diag, y, masks, state = _multi_problem(cuda, 2048, 3)
    caps = [250, 250, 180]
    shared = ops.smo_chunk_lanes(K, diag, y, masks, [ds.C] * 3, 1e-3, caps,
                                 251, "2", *state, _route=route)
    copies = ops.smo_chunk_sources(K.expand(3, -1, -1), diag.expand(3, -1),
                                   y.expand(3, -1), masks, [ds.C] * 3, 1e-3,
                                   caps, 251, "2", *state, _route=route)
    _routes_equal(shared, copies)


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["pair", "persistent"])
@pytest.mark.parametrize("n,cap", [(1000, 300), (3000, 1024)])
def test_cuda_stream_sources_bitwise_solo(cuda, route, n, cap):
    """Three lanes with their own compact X in one chunk on each streaming
    route: each lane bitwise its own ``smo_stream_chunk`` over its own X on
    either route; within 1e-10 of the plain loop after a capped run (its
    products are a matmul, not the kernels' ordered fma)."""
    from repro_torch.kernels.smo_chunk import pad_rows
    ds, (Xs, sqs, sns), ys, masks, state = _compact_lanes(cuda, n, cap, 3,
                                                          stream=True)
    caps = [200, 150, 200]
    before = ops.route_counts()["smo_stream_chunk_sources"][route]
    got = ops.smo_stream_chunk_sources(Xs, sqs, ds.gamma, ys, masks,
                                       [ds.C] * 3, 1e-3, caps, 201, *state,
                                       X_rows=pad_rows(Xs), X_norms=sns,
                                       _route=route)
    assert ops.route_counts()["smo_stream_chunk_sources"][route] == \
        before + 1
    assert got[2].tolist() == caps
    for l in range(3):
        for r in ("pair", "persistent"):
            solo = _stream_chunk(Xs[l], sqs[l], ds.gamma, ys[l],
                                 masks[l:l + 1], [ds.C], 1e-3, [caps[l]],
                                 201, *(t[l:l + 1] for t in state), _route=r)
            _routes_equal(tuple(t[l:l + 1] for t in got), solo)
    plain = ref.smo_chunk_sources_ref(None, None, ys, masks, [ds.C] * 3,
                                      1e-3, caps, 201, "1", *state,
                                      stream=(Xs, sqs, ds.gamma))
    for k in (0, 1):
        torch.testing.assert_close(got[k], plain[k], rtol=0, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("n,cap,width", [(1000, 300, 4), (32_560, 30_720,
                                                         12)])
def test_cuda_stacked_stream_sources_one_copy(cuda, n, cap, width):
    """``stack_sources`` over compact ``PallasRBF`` lanes on the card: one
    copy of the lanes' X, laid out for the route that reads it (a view of
    the padded rows where the persistent route places the lanes,
    contiguous with no padded rows for the pair route), pad slots zeros;
    ``chunk_batched_sources`` over it gives each lane its own chunk, bit
    for bit."""
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.kernels.smo_chunk import stream_plan
    from repro_torch.svm.engine import (EngineState, PallasRBF,
                                        chunk_batched_sources, smo_chunk,
                                        stack_sources)
    ds = make_dataset("adult", n_override=n)
    full = PallasRBF(torch.from_numpy(ds.X[:n]).to(cuda), ds.gamma)
    y = torch.from_numpy(ds.y[:n]).to(cuda, torch.float64)
    g = torch.Generator().manual_seed(3)
    idx = [torch.sort(torch.randperm(n, generator=g)[:cap]).values.to(cuda)
           for _ in range(3)]
    srcs = [full.compact(i) for i in idx]
    st = stack_sources(srcs, width)
    persistent = stream_plan(cap, ds.X.shape[1], 1, width)[0] >= 1
    assert ("X_rows" in st.__dict__) == persistent
    if persistent:
        assert st.X_rows is st.X and st.X.stride(1) == st.X.shape[2] + 1
    else:
        assert st.X.is_contiguous()
    assert not st.X[3:].any()
    for l in range(3):
        assert torch.equal(st.X[l], srcs[l].X)
    ys = torch.stack([y[i] for i in idx] + [y[idx[0]]] * (width - 3))
    masks = torch.ones((width, cap), dtype=torch.bool, device=cuda)
    states = EngineState(torch.zeros((width, cap), dtype=torch.float64,
                                     device=cuda), -ys,
                         torch.zeros(width, dtype=torch.int64, device=cuda),
                         torch.arange(width, device=cuda) >= 3)
    out = chunk_batched_sources(st, ys, masks, [ds.C] * width, 1e-3,
                                [100] * width, states, 100, "1")
    for l in range(3):
        one = smo_chunk(srcs[l], ys[l], masks[l], ds.C, states.lane(l),
                        n_iters=100, wss="1", tol=1e-3, it_cap=100)
        for a, b in zip(out.lane(l), one):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_dense_compact_peak_memory(cuda):
    """``DenseKernel.compact`` gathers in slabs of rows into the result:
    its peak is the compact K (cap^2 x 8 bytes) and one slab of K
    (``GATHER_ELEMS`` entries), never a (cap, n) intermediate or a (cap,
    cap) index."""
    from repro_torch.svm.engine import GATHER_ELEMS, DenseKernel
    n, cap = 12_000, 6_000
    K = torch.rand((n, n), dtype=torch.float64, device=cuda)
    idx = torch.sort(torch.randperm(n, device=cuda)[:cap]).values
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    comp = DenseKernel(K).compact(idx)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    assert peak <= cap * cap * 8 + GATHER_ELEMS * 8 + 4 * 1024 * 1024, peak
    assert torch.equal(comp.K[5], K[idx[5]][idx])


@pytest.mark.cuda
@pytest.mark.parametrize("shrink_every", [0, 128])
def test_cuda_run_cv_returns_its_memory_without_gc(cuda, shrink_every):
    """Once ``run_cv`` returns and its result is dropped, the card's
    allocated bytes are back at their baseline by reference counting
    alone (the cyclic collector off): no finished pool keeps its K or its
    lanes' compact K."""
    import gc

    from repro_torch.core.cv import run_cv
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("adult", n_override=1000)
    kw = dict(k=10, method="sir", shrink_every=shrink_every,
              shrink_quantum=32)
    run_cv(ds, **kw)          # builds the kernels and their plans
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    gc.disable()
    try:
        res = run_cv(ds, **kw)
        assert all(f.converged for f in res.folds)
        del res
        torch.cuda.synchronize()
        assert torch.cuda.memory_allocated() == base
    finally:
        gc.enable()


@pytest.mark.cuda
def test_cuda_svc_equals_cpu(cuda):
    """``SVC`` on the card predicts as ``SVC`` on the CPU (heart n = 270,
    with and without shrinking)."""
    from repro_torch.data.svm_suite import make_dataset
    from repro_torch.svm import SVC
    ds = make_dataset("heart", n_override=270)
    X, y = ds.X[:200], ds.y[:200]
    for kw in ({}, {"shrink_every": 64, "shrink_quantum": 32}):
        on = SVC(C=ds.C, gamma=ds.gamma, **kw).fit(X, y)
        off = SVC(C=ds.C, gamma=ds.gamma, device="cpu", **kw).fit(X, y)
        assert on.result_.alpha.device.type == "cuda"
        assert np.array_equal(on.predict(ds.X[200:]),
                              off.predict(ds.X[200:]))


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["dense", "pallas_rbf"])
def test_cuda_shrink_pool_runs_per_lane_kernels(cuda, backend):
    """``run_cv_batched`` with shrinking on the card: compact groups of
    more than one lane go through the per-lane kernels, and every fold
    scores as without shrinking."""
    from repro_torch.core.cv import run_cv_batched
    from repro_torch.data.svm_suite import make_dataset
    ds = make_dataset("adult", n_override=1000)
    plain = run_cv_batched(ds, k=10, source_backend=backend)
    ops.reset_launch_counts()
    shr = run_cv_batched(ds, k=10, source_backend=backend, shrink_every=128,
                         shrink_quantum=64, chunk_iters=128)
    key = "smo_stream_chunk_sources" if backend == "pallas_rbf" \
        else "smo_chunk_sources"
    assert sum(ops.route_counts()[key].values()) > 0
    assert [f.acc_correct for f in shr.folds] == \
        [f.acc_correct for f in plain.folds]
    assert all(f.converged for f in shr.folds)


# ------------------------------------------------ the study service's path


def _service_plan(ds, chunks, masks, y, X, C_scale=1.0, folds=(0, 1, 2),
                  sir=True):
    """A fold chain over a declared kernel: the first fold cold, the rest
    SIR-seeded (or cold) with ``after`` edges, each evaluated."""
    from repro_torch.core.cv import _transition_idx
    from repro_torch.core.study import Plan
    from repro_torch.svm import KernelSpec
    n = y.shape[0]
    plan = Plan(sources={"adult": KernelSpec(X=X, gamma=ds.gamma, n=n)},
                y=y, chunk_iters=1024)
    prev = None
    for h in folds:
        common = dict(train_mask=masks[h], C=ds.C * C_scale, after=prev)
        if prev is None or not sir:
            plan.lane(h, alpha0=torch.zeros_like(y), f0=-y, **common)
        else:
            S, R, T = _transition_idx(chunks, prev, h)
            plan.lane(h, dep=prev, transform="fold", params=dict(
                method="sir", S_idx=S, R_idx=R, T_idx=T), **common)
        plan.evaluate(h, chunks[h])
        prev = h
    return plan


def _same_bits(want, got) -> None:
    assert set(want) == set(got)
    for lid, w in want.items():
        g = got[lid]
        assert torch.equal(w.alpha.cpu(), g.alpha.cpu()), lid
        assert torch.equal(w.f.cpu(), g.f.cpu()), lid
        assert int(w.n_iter) == int(g.n_iter)


@pytest.fixture
def adult_1000(cuda):
    from repro_torch.core.cv import _fold_masks
    from repro_torch.data.svm_suite import kfold_chunks, make_dataset
    ds = make_dataset("adult", n_override=1000)
    chunks = kfold_chunks(ds.n, 10)
    n = chunks.size
    X = torch.as_tensor(ds.X[:n], device=cuda)
    y = torch.as_tensor(ds.y[:n], dtype=torch.float64, device=cuda)
    masks = torch.as_tensor(_fold_masks(chunks), device=cuda)
    return ds, chunks, masks, y, X


@pytest.mark.cuda
def test_cuda_pool_snapshot_restores_bitwise(cuda, adult_1000, tmp_path):
    """A live pool's snapshot mid-flight (some lanes retired, one packed),
    restored into a new pool of another width through ``run_plan``'s
    record: every lane bitwise the uninterrupted run."""
    import shutil
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.study import StudyCheckpoint, run_plan
    ds, chunks, masks, y, X = adult_1000
    plan = _service_plan(ds, chunks, masks, y, X, folds=range(6), sir=False)
    for spec in plan.lanes:
        spec.after = None                   # all live at once: packed
    plan.chunk_iters = 128
    want = run_plan(plan)
    mgr = CheckpointManager(str(tmp_path), max_to_keep=10_000)
    run_plan(plan, checkpoint=StudyCheckpoint(manager=mgr, meta={"t": 1}))
    steps = mgr.all_steps()
    mixed = [s for s in steps
             if 0 < mgr.restore(step=s)[1]["done"].sum() < 6]
    for s in steps:
        if s > mixed[0]:
            shutil.rmtree(mgr._step_dir(s))
    plan.max_width = 1
    got = run_plan(plan, checkpoint=StudyCheckpoint(
        manager=CheckpointManager(str(tmp_path), max_to_keep=10_000),
        meta={"t": 1}))
    assert 0 < len(got.restored) < 6
    _same_bits(want.results, got.results)
    assert got.evals == want.evals


@pytest.mark.cuda
def test_cuda_two_tenants_one_service_bitwise(cuda, adult_1000):
    """Two tenants on one ``StudyService(device="cuda")``: tenant a's SIR
    chain, tenant b's cold folds at 4 x C, one kernel for both; each lane
    bitwise the in-process ``run_plan`` on the card."""
    import json
    from repro_torch.core.study import (_from_wire, plan_to_dict,
                                        result_from_dict, run_plan)
    from repro_torch.service import StudyService
    ds, chunks, masks, y, X = adult_1000
    plan_a = _service_plan(ds, chunks, masks, y, X)
    plan_b = _service_plan(ds, chunks, masks, y, X, C_scale=4.0,
                           folds=(3, 4), sir=False)
    solo = {"a": run_plan(plan_a), "b": run_plan(plan_b)}
    service = StudyService(chunk_iters=512, max_width=0)
    assert service.pool.device.type == "cuda"
    events = {"a": [], "b": []}
    ops.reset_launch_counts()
    for t, plan in (("a", plan_a), ("b", plan_b)):
        service.submit(t, "p", json.loads(json.dumps(plan_to_dict(plan))),
                       events[t].append)
    while service._studies:
        service.pool.step()
        service._finish_ready()
    assert ops.launch_counts()["rbf_kernel_matrix"] == 1
    for t in ("a", "b"):
        served = {_from_wire(m["lane"]): result_from_dict(m["result"])
                  for m in events[t] if m["type"] == "result"}
        _same_bits(solo[t].results, served)
        (done,) = [m for m in events[t] if m["type"] == "done"]
        assert {lid: tuple(ct) for lid, ct in done["evals"]} == \
            solo[t].evals
        assert done["tenant_stats"]["served"] > 0
    assert [m["dedup_hits"] for m in events["b"]
            if m["type"] == "admitted"] == [1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["dense", "pallas_rbf"])
def test_cuda_auto_verdicts_are_the_files(cuda, kind):
    """``max_width=None`` and ``shrink_every="auto"`` on the card take the
    measured ``cuda`` entries of ``results/cost_model_torch.json``."""
    import json
    import pathlib
    from repro_torch.svm import DenseKernel, LanePool, PallasRBF, cost_model
    path = pathlib.Path(__file__).resolve().parents[1] / "results" / \
        "cost_model_torch.json"
    entry = json.loads(path.read_text())["entries"]["cuda"][kind]
    X = torch.rand(64, 5, dtype=torch.float64, device=cuda)
    source = DenseKernel(X @ X.T) if kind == "dense" else PallasRBF(X, 0.5)
    pool = LanePool({"s": source}, torch.ones(64, dtype=torch.float64,
                                              device=cuda),
                    wss="1" if kind == "pallas_rbf" else "2",
                    max_width=None, shrink_every="auto")
    assert pool.max_width == entry["max_width"] == \
        cost_model.pick_max_width("cuda", (kind,))
    assert bool(pool.shrink_every) is entry["shrink"] is \
        cost_model.pick_shrink("cuda", (kind,))


@pytest.mark.cuda
def test_cuda_save_copies_state_before_its_writer(cuda, tmp_path,
                                                 monkeypatch):
    """``save`` copies card tensors to host before its writer thread runs:
    a pool state mutated in place after ``save`` returns leaves the record
    as it was."""
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint import manager as manager_mod
    go = threading.Event()
    real = manager_mod.save_pytree

    def held(*args, **kwargs):
        go.wait(10)
        return real(*args, **kwargs)

    monkeypatch.setattr(manager_mod, "save_pytree", held)
    alpha = torch.arange(1000, dtype=torch.float64, device=cuda)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, {"alpha": alpha, "n_iter": torch.tensor(5, device=cuda)},
             blocking=False)
    alpha.mul_(-1.0)
    torch.cuda.synchronize()
    go.set()
    mgr.wait()
    _, flat, _ = mgr.restore()
    assert np.array_equal(flat["alpha"], np.arange(1000, dtype=np.float64))
    assert int(flat["n_iter"]) == 5


# ------------------------------------------------- mamba's selective scan ----

def _scan_case(cuda, B, S, Din, dtype, state, seed=0):
    """Seeded scan inputs on the card: u ~ N(0, 1), dt = softplus(N(0, 1)),
    A = -exp(1 + N(0, 1) / 2), B and C ~ N(0, 1), h0 ~ N(0, 1)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape)).float().to(cuda)
    u = t(B, S, Din).to(dtype)
    dt = torch.nn.functional.softplus(t(B, S, Din)).to(dtype)
    A = -torch.exp(1.0 + 0.5 * t(Din, 16))
    return (u, dt, A, t(B, S, 16).to(dtype), t(B, S, 16).to(dtype),
            t(B, Din, 16) if state else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,Din,state", [
    (2, 1000, 512, False), (4, 777, 200, True), (4, 1, 8192, True),
    (1, 64, 16, False), (3, 130, 48, True)],
    ids=["ragged_s", "ragged_din_h0", "decode", "one_round", "b3_h0"])
def test_cuda_selective_scan_matches_plain(cuda, dtype, B, S, Din, state):
    """The kernel against its plain version on the same inputs: float32 y
    and final state within 1e-5 row by row (the sums over the 16 states
    run in other orders, the kernel's exp is the SFU's); bf16 y within one
    bf16 ulp (the same roundings of dt * u and of y on both sides, so an
    output differs only where the float32 sums straddle a rounding) and
    the state within 1e-5. A ragged S (not a multiple of the 64-step
    rounds), a ragged Din (the last block's channels masked), B > 1, and
    the decode step (S = 1 from a nonzero state, written back in place)."""
    u, dt, A, Bp, Cp, h0 = _scan_case(cuda, B, S, Din, dtype, state)
    want, h_want = ref.selective_scan_ref(u, dt, A, Bp, Cp, h0)
    before = ops.launch_counts()["selective_scan"]
    h = h0.clone() if state else torch.empty((B, Din, 16), device=cuda)
    got = ops.selective_scan(u, dt, A, Bp, Cp, h if state else None, h)
    assert ops.launch_counts()["selective_scan"] == before + 1
    assert got.dtype == dtype and got.shape == (B, S, Din)
    assert _row_rel(h, h_want) <= 1e-5
    if dtype == torch.float32:
        assert _row_rel(got, want) <= 1e-5
    else:
        torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -7,
                                   atol=1e-5 * float(want.abs().max()))


@pytest.mark.cuda
def test_cuda_selective_scan_refuses_what_it_does_not_take(cuda):
    """A CUDA tensor the kernel does not take raises, with no launch and no
    fallback to the plain version: float64, a state width other than 16,
    a non-contiguous input, a bf16 state, a tensor on the CPU beside ones
    on the card."""
    u, dt, A, Bp, Cp, h0 = _scan_case(cuda, 2, 10, 32, torch.float32, True)
    before = ops.launch_counts()["selective_scan"]
    bad = [
        (TypeError, (u.double(), dt.double(), A, Bp.double(), Cp.double())),
        (ValueError, (u, dt, A[:, :8].contiguous(), Bp[..., :8].contiguous(),
                      Cp[..., :8].contiguous())),
        (ValueError, (u.transpose(0, 1).contiguous().transpose(0, 1), dt, A,
                      Bp, Cp)),
        (TypeError, (u, dt, A, Bp, Cp, h0.bfloat16())),
        (ValueError, (u, dt, A.cpu(), Bp, Cp)),
    ]
    for err, args in bad:
        with pytest.raises(err):
            ops.selective_scan(*args)
    assert ops.launch_counts()["selective_scan"] == before


@pytest.mark.cuda
def test_cuda_smoke_jamba_matches_its_cpu_run(cuda):
    """SMOKE Jamba (7 mamba layers, 1 NoPE attention layer, MoE every
    second layer) in float32 on the card against the same model on the
    CPU: each prefill launches selective_scan 7 times and flash_attention
    once, with logits within 1e-4; teacher-forced decode through the
    caches (the mamba state float32, in place) launches the scan 7 times a
    step, with logits within 1e-4 of the CPU's."""
    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_model)
    from repro_torch.serving import prefill_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    cpu = init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = init_model(cfg, seed=0, dtype=torch.float32, device="cpu").to(cuda)
    batch = concrete_batch(cfg, 2, 70, device="cpu")
    before = ops.launch_counts()
    got = prefill_logits(card, {"tokens": batch["tokens"].to(cuda)})
    after = ops.launch_counts()
    assert after["selective_scan"] - before["selective_scan"] == 7
    assert after["flash_attention"] - before["flash_attention"] == 1
    torch.testing.assert_close(got.cpu(), prefill_logits(cpu, batch),
                               rtol=0, atol=1e-4)
    caches = [init_cache(cfg, 2, 6, torch.float32, device=d)
              for d in ("cpu", cuda)]
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        want, _ = decode_step(cpu, caches[0], {"tokens": tok, "step": t})
        scans = ops.launch_counts()["selective_scan"]
        got, _ = decode_step(card, caches[1], {"tokens": tok.to(cuda),
                                               "step": t})
        assert ops.launch_counts()["selective_scan"] - scans == 7
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-4)
    for a, b in zip(caches[0]["layers"], caches[1]["layers"], strict=True):
        for key in a:
            assert a[key].dtype == b[key].dtype
            torch.testing.assert_close(b[key].cpu(), a[key], rtol=0,
                                       atol=1e-4)


@pytest.mark.cuda
def test_cuda_smoke_mamba_bf16_decode_one_request(cuda):
    """SMOKE mamba in bf16 decoding a single request (B = S = 1, where B
    and C are contiguous slices of the projection dt_rank = 4 elements in:
    8 bytes, off the kernel's 16-byte alignment unless copied): each step
    launches the kernel once, the state stays float32, and the steps match
    the prefill form over the same tokens within 2e-2 of its scale (the
    reference's own decode-against-forward bar)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    assert max(cfg.d_model // 16, 1) * 2 % 16 != 0
    p = init_params(ssm.mamba_def(cfg), torch.Generator(cuda).manual_seed(4),
                    torch.bfloat16, cuda)
    cache = init_params(ssm.mamba_cache_def(cfg, 1), torch.Generator(cuda),
                        torch.bfloat16, cuda)
    x = torch.randn((1, 12, cfg.d_model), device=cuda,
                    generator=torch.Generator(cuda).manual_seed(5)
                    ).to(torch.bfloat16)
    pre, _ = ssm.mamba_apply(p, x, cfg)
    steps = []
    for t in range(x.shape[1]):
        before = ops.launch_counts()["selective_scan"]
        d, cache = ssm.mamba_apply(p, x[:, t:t + 1], cfg, cache=cache)
        assert ops.launch_counts()["selective_scan"] == before + 1
        steps.append(d)
    assert cache["ssm"].dtype == torch.float32
    assert cache["conv"].dtype == torch.bfloat16
    dec = torch.cat(steps, 1).float()
    assert float((dec - pre.float()).abs().max()) <= 2e-2 * float(
        pre.float().abs().max())


@pytest.mark.cuda
def test_cuda_scan_and_mamba_make_no_host_sync(cuda):
    """The scan and ``mamba_apply`` (prefill, and decode through its cache)
    on the card under ``set_sync_debug_mode("error")``: nothing waits for
    the card (``jit_lint.SYNC_FREE`` names both)."""
    from repro_torch.configs import get_config
    from repro_torch.models import ssm
    from repro_torch.models.params import init_params
    cfg = get_config("jamba-v0.1-52b", smoke=True)
    p = init_params(ssm.mamba_def(cfg), torch.Generator(cuda).manual_seed(3),
                    torch.bfloat16, cuda)
    cache = init_params(ssm.mamba_cache_def(cfg, 3), torch.Generator(cuda),
                        torch.bfloat16, cuda)
    x = torch.randn((3, 20, cfg.d_model), device=cuda, dtype=torch.bfloat16)
    scan_args = _scan_case(cuda, 3, 50, 64, torch.bfloat16, True)
    # warm up (first launches, the library's load)
    ssm.mamba_apply(p, x, cfg)
    ssm.mamba_apply(p, x[:, :1], cfg, cache=cache)
    ops.selective_scan(*scan_args, h_out=scan_args[-1])
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ops.selective_scan(*scan_args, h_out=scan_args[-1])
        y, _ = ssm.mamba_apply(p, x, cfg)
        for t in range(3):
            d, cache = ssm.mamba_apply(p, x[:, t:t + 1], cfg, cache=cache)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cache["ssm"].dtype == torch.float32
    assert bool(torch.isfinite(y).all()) and bool(torch.isfinite(d).all())


# ------------------------------------------- xLSTM: sLSTM and mLSTM kernels ----

def _slstm_case(cuda, B, S, D, dtype, carry, seed=0):
    """Seeded sLSTM inputs on the card, as the model makes them: the four
    gate inputs of one (B, S, 4 D) projection (views with its strides),
    ~ N(0, 1) (gi and gf at the init's 0.02 fan-in scale times sqrt(D)),
    rz ~ N(0, 0.02^2), bf ones; with ``carry`` a nonzero (c, n, h, m)."""
    rng = np.random.default_rng(seed)

    def t(*shape, scale=1.0):
        return (torch.from_numpy(rng.normal(size=shape)).float()
                * scale).to(cuda)
    g = t(B, S, 4 * D)
    g[..., D:3 * D] *= 0.02 * D ** 0.5
    g = g.to(dtype)
    gz, gi, gf, go = g.split(D, dim=-1)
    rz = t(D, D, scale=0.02).to(dtype)
    bf = torch.ones(D, device=cuda, dtype=dtype)
    c0 = None
    if carry:
        c0 = (t(B, D), t(B, D).abs() + 1.0, t(B, D, scale=0.5).to(dtype),
              t(B, D, scale=0.1))
    return gz, gi, gf, go, rz, bf, c0


def _empty_carry(B, D, dtype, device):
    return tuple(torch.empty((B, D), device=device,
                             dtype=dtype if k == 2 else torch.float32)
                 for k in range(4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,D,carry", [
    (2, 300, 64, False), (3, 257, 768, True), (1, 1000, 768, False),
    (4, 1, 768, True), (5, 33, 64, True)],
    ids=["smoke_width", "full_width_carry", "long", "decode", "b5_carry"])
def test_cuda_slstm_scan_matches_plain(cuda, dtype, B, S, D, carry):
    """The kernel against its plain version (the loop of ``_slstm_step``)
    on the same inputs, at SMOKE's D = 64 and the full 768, B > 1, from
    zeros and from a nonzero carry: float32 hs and final carry within 1e-5
    row by row (the dot product h @ rz sums in another order); bf16 hs
    within 0.02 of the plain version run in float32 on the same bf16
    inputs, and within twice the bf16 plain version's own error there, its
    final float32 state likewise."""
    gz, gi, gf, go, rz, bf, c0 = _slstm_case(cuda, B, S, D, dtype, carry)
    out = _empty_carry(B, D, dtype, cuda)
    before = ops.launch_counts()["slstm_scan"]
    got = ops.slstm_scan(gz, gi, gf, go, rz, bf, c0, out)
    assert ops.launch_counts()["slstm_scan"] == before + 1
    assert got.dtype == dtype and got.shape == (B, S, D)
    if dtype == torch.float32:
        want, last = ref.slstm_scan_ref(gz, gi, gf, go, rz, bf, c0)
        assert _row_rel(got, want) <= 1e-5
        for a, b in zip(out, last, strict=True):
            assert _row_rel(a, b) <= 1e-5
        return
    f32 = [t.float() for t in (gz, gi, gf, go, rz, bf)]
    want, last = ref.slstm_scan_ref(*f32, None if c0 is None else (
        c0[0], c0[1], c0[2].float(), c0[3]))
    plain, _ = ref.slstm_scan_ref(gz, gi, gf, go, rz, bf, c0)
    err, own = _row_rel(got, want), _row_rel(plain, want)
    assert err <= 0.02 and err <= 2.0 * max(own, 2 ** -9), (err, own)
    assert _row_rel(out[0], last[0]) <= 0.02


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [64, 768])
def test_cuda_slstm_steps_in_place_equal_one_launch(cuda, dtype, D):
    """Decode's form: S launches at S = 1 with the carry passed as both
    ``carry`` and ``carry_out`` (the cache, rewritten in place) give the
    outputs and final carry of one launch over the S steps, bit for bit:
    each step is the same arithmetic on the same values."""
    gz, gi, gf, go, rz, bf, c0 = _slstm_case(cuda, 2, 17, D, dtype, True, 1)
    out = _empty_carry(2, D, dtype, cuda)
    whole = ops.slstm_scan(gz, gi, gf, go, rz, bf, c0, out)
    cache = tuple(t.clone() for t in c0)
    steps = []
    for t in range(17):
        steps.append(ops.slstm_scan(gz[:, t:t + 1], gi[:, t:t + 1],
                                    gf[:, t:t + 1], go[:, t:t + 1], rz, bf,
                                    cache, cache))
    assert torch.equal(torch.cat(steps, 1), whole)
    for a, b in zip(cache, out, strict=True):
        assert torch.equal(a, b)


def _mlstm_case(cuda, B, S, H, dh, dtype, seed=0):
    """Seeded mLSTM inputs on the card, as the model makes them: q, k, v ~
    N(0, 1) in ``dtype``; logi ~ N(0, 0.1^2) (the input gate's 0.02 init
    and zero bias); logf = log_sigmoid(1 + N(0, 0.1^2)) (its ones bias)."""
    rng = np.random.default_rng(seed)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape)).float().to(cuda)
    q, k, v = (t(B, S, H, dh).to(dtype) for _ in range(3))
    logi = 0.1 * t(B, S, H)
    logf = ref.log_sigmoid_ref(1.0 + 0.1 * t(B, S, H))
    return q, k, v, logi, logf


def _mlstm_bf16_held(got, q, k, v, logi, logf):
    """A bf16 mlstm_parallel output against the plain version run in
    float32 on the same bf16 inputs, every row held as ``chip_smoke.py``
    holds them: its largest row error within twice the bf16 plain
    version's own and within 0.04 (MLSTM_ROW_REL: on these inputs the den
    does not cancel, and the plain version's largest row is under 0.02),
    its median row within 0.015, and no row off by more than twice the
    plain version's error on the same row plus 2^-7 (one bf16 ulp of the
    row's largest element)."""
    want = ref.mlstm_parallel_ref(q.float(), k.float(), v.float(), logi,
                                  logf)
    err = _row_rel(got, want)
    plain = ref.mlstm_parallel_ref(q, k, v, logi, logf)
    own = _row_rel(plain, want)
    w = want.float()

    def rows_of(h):
        return (h.float() - w).abs().amax(-1) / w.abs().amax(-1).clamp_min(
            1e-30)
    rows, own_rows = rows_of(got), rows_of(plain)
    assert err <= 2.0 * max(own, 2 ** -9) and err <= 0.04, (err, own)
    assert float(rows.median()) <= 0.015, float(rows.median())
    over = int((rows > 2.0 * own_rows + 2 ** -7).sum())
    assert over == 0, over


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,H,dh", [
    (2, 100, 2, 64), (1, 200, 4, 384), (3, 65, 2, 64), (1, 1, 4, 384),
    (2, 130, 4, 384), (1, 1000, 2, 64), (3, 65, 2, 384), (1, 777, 4, 384),
    (1, 1, 2, 64)],
    ids=["smoke", "full_dh", "tail_b3", "one_row", "ragged_full",
         "long", "tail_b3_full", "ragged_777", "one_row_smoke"])
def test_cuda_mlstm_parallel_matches_plain(cuda, dtype, B, S, H, dh):
    """The kernel on its chosen route (``mlstm.route``: fma for float32,
    wgmma for bf16 at dh = 384, mma at 64) against its plain version (the
    reference's materialised form) on the same inputs: S not a multiple
    of the 64-row (bf16) or 16-row (float32) tiles, B > 1, S = 1, dh at
    SMOKE's 64 and the full 384. float32 within 1e-5 row by row (sums in
    other orders); bf16 as ``_mlstm_bf16_held``."""
    from repro_torch.kernels.mlstm import route
    q, k, v, logi, logf = _mlstm_case(cuda, B, S, H, dh, dtype)
    took = route(dtype, dh)
    assert took == ("fma" if dtype == torch.float32
                    else "wgmma" if dh == 384 else "mma")
    before = dict(ops.route_counts()["mlstm_parallel"])
    got = ops.mlstm_parallel(q, k, v, logi, logf)
    after = ops.route_counts()["mlstm_parallel"]
    assert after == {r: n + (r == took) for r, n in before.items()}
    assert got.dtype == dtype and got.shape == (B, S, H, dh)
    if dtype == torch.float32:
        want = ref.mlstm_parallel_ref(q, k, v, logi, logf)
        err = _row_rel(got, want)
        assert err <= 1e-5, err
        return
    _mlstm_bf16_held(got, q, k, v, logi, logf)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,H", [(1, 1, 4), (3, 65, 2), (2, 130, 4),
                                   (1, 777, 4), (1, 1000, 4)])
def test_cuda_mlstm_wgmma_and_mma_routes_agree(cuda, B, S, H):
    """At dh = 384 the wgmma route and the forced mma route, on the same
    bf16 inputs, each held to the plain version as
    ``_mlstm_bf16_held``, and within those bars of each other: the
    largest row of their difference within 0.04 of the rows' scale, the
    median within 0.015."""
    q, k, v, logi, logf = _mlstm_case(cuda, B, S, H, 384, torch.bfloat16, 3)
    before = dict(ops.route_counts()["mlstm_parallel"])
    wg = ops.mlstm_parallel(q, k, v, logi, logf)
    mma = ops.mlstm_parallel(q, k, v, logi, logf, _route="mma")
    after = ops.route_counts()["mlstm_parallel"]
    assert after["wgmma"] == before["wgmma"] + 1
    assert after["mma"] == before["mma"] + 1
    for got in (wg, mma):
        _mlstm_bf16_held(got, q, k, v, logi, logf)
    m = mma.float()
    rows = (wg.float() - m).abs().amax(-1) / m.abs().amax(-1).clamp_min(
        1e-30)
    assert float(rows.max()) <= 0.04, float(rows.max())
    assert float(rows.median()) <= 0.015, float(rows.median())


@pytest.mark.cuda
def test_cuda_mlstm_route_that_cannot_take_the_inputs_raises(cuda):
    """A forced route built for other inputs raises before any launch, and
    no count moves: wgmma at dh = 64 and on float32, mma on float32, fma
    on bf16, and a route that does not exist."""
    bf64 = _mlstm_case(cuda, 1, 20, 2, 64, torch.bfloat16)
    f384 = _mlstm_case(cuda, 1, 20, 2, 384, torch.float32)
    b384 = _mlstm_case(cuda, 1, 20, 2, 384, torch.bfloat16)
    launches = ops.launch_counts()["mlstm_parallel"]
    routes = dict(ops.route_counts()["mlstm_parallel"])
    for args, r in ((bf64, "wgmma"), (f384, "wgmma"), (f384, "mma"),
                    (b384, "fma"), (b384, "tma")):
        with pytest.raises(ValueError, match="route"):
            ops.mlstm_parallel(*args, _route=r)
    assert ops.launch_counts()["mlstm_parallel"] == launches
    assert ops.route_counts()["mlstm_parallel"] == routes


@pytest.mark.cuda
def test_cuda_mlstm_plain_rows_are_the_whole_form(cuda):
    """``mlstm_parallel_ref`` on a range of query rows is those rows of the
    whole form (how ``chip_smoke.py`` holds the kernel at 32k rows), and
    the kernel's rows there match it."""
    q, k, v, logi, logf = _mlstm_case(cuda, 1, 300, 4, 384, torch.float32,
                                      seed=2)
    whole = ref.mlstm_parallel_ref(q, k, v, logi, logf)
    rows = ref.mlstm_parallel_ref(q, k, v, logi, logf, rows=(200, 300))
    assert torch.equal(rows, whole[:, 200:])
    got = ops.mlstm_parallel(q, k, v, logi, logf)
    assert _row_rel(got[:, 200:], rows) <= 1e-5


@pytest.mark.cuda
def test_cuda_xlstm_kernels_refuse_what_they_do_not_take(cuda):
    """A CUDA tensor a kernel does not take raises, with no launch and no
    fallback to the plain version. mlstm_parallel: float64, a head dim it
    is not built for (128), a non-contiguous q, bf16 gates, a tensor on
    the CPU. slstm_scan: float64, a width it does not run at (128), gates
    with other strides, a carry with a bf16 c, a tensor on the CPU."""
    q, k, v, logi, logf = _mlstm_case(cuda, 1, 20, 2, 64, torch.bfloat16)
    q2, k2, v2, li2, lf2 = _mlstm_case(cuda, 1, 20, 2, 128, torch.bfloat16)
    before = ops.launch_counts()
    bad = [
        (TypeError, (q.double(), k.double(), v.double(), logi, logf)),
        (ValueError, (q2, k2, v2, li2, lf2)),
        (ValueError, (q.transpose(1, 2).contiguous().transpose(1, 2), k, v,
                      logi, logf)),
        (TypeError, (q, k, v, logi.bfloat16(), logf)),
        (ValueError, (q, k, v, logi.cpu(), logf)),
    ]
    for err, args in bad:
        with pytest.raises(err):
            ops.mlstm_parallel(*args)
    gz, gi, gf, go, rz, bf, c0 = _slstm_case(cuda, 2, 5, 64, torch.float32,
                                             True)
    g128 = _slstm_case(cuda, 2, 5, 128, torch.float32, False)
    bad = [
        (TypeError, (gz.double(), gi.double(), gf.double(), go.double(),
                     rz.double(), bf.double())),
        (ValueError, g128[:6]),
        (ValueError, (gz.contiguous(), gi, gf, go, rz, bf)),
        (ValueError, (gz, gi, gf, go, rz, bf, (c0[0].bfloat16(),) + c0[1:])),
        (ValueError, (gz, gi, gf, go, rz.cpu(), bf)),
    ]
    for err, args in bad:
        with pytest.raises(err):
            ops.slstm_scan(*args)
    after = ops.launch_counts()
    assert after["mlstm_parallel"] == before["mlstm_parallel"]
    assert after["slstm_scan"] == before["slstm_scan"]


@pytest.mark.cuda
def test_cuda_smoke_xlstm_matches_its_cpu_run(cuda):
    """SMOKE xLSTM (2 mLSTM + 2 sLSTM layers) in float32 on the card against
    the same model on the CPU: each prefill launches mlstm_parallel twice
    (the fma route) and slstm_scan twice; teacher-forced decode through
    the caches (every state float32, in place) launches slstm_scan twice a
    step and mlstm_parallel never; logits and caches within 2e-5 of their
    scale of the CPU's (the tied table gives logits up to ~30; the sums run
    in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.launch.inputs import concrete_batch
    from repro_torch.models.transformer import (decode_step, init_cache,
                                                init_model)
    from repro_torch.serving import prefill_logits
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("xlstm-125m", smoke=True)
    cpu = init_model(cfg, seed=0, dtype=torch.float32, device="cpu")
    card = init_model(cfg, seed=0, dtype=torch.float32, device="cpu").to(cuda)
    batch = concrete_batch(cfg, 2, 70, device="cpu")
    before = ops.launch_counts()
    got = prefill_logits(card, {"tokens": batch["tokens"].to(cuda)})
    after = ops.launch_counts()
    assert after["mlstm_parallel"] - before["mlstm_parallel"] == 2
    assert after["slstm_scan"] - before["slstm_scan"] == 2
    want = prefill_logits(cpu, batch)
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=2e-5 * float(want.abs().max()))
    caches = [init_cache(cfg, 2, 6, torch.float32, device=d)
              for d in ("cpu", cuda)]
    for t in range(6):
        tok = batch["tokens"][:, t:t + 1]
        want, _ = decode_step(cpu, caches[0], {"tokens": tok, "step": t})
        before = ops.launch_counts()
        got, _ = decode_step(card, caches[1], {"tokens": tok.to(cuda),
                                               "step": t})
        after = ops.launch_counts()
        assert after["slstm_scan"] - before["slstm_scan"] == 2
        assert after["mlstm_parallel"] == before["mlstm_parallel"]
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=2e-5 * float(want.abs().max()))
    for a, b in zip(caches[0]["layers"], caches[1]["layers"], strict=True):
        for key in a:
            assert a[key].dtype == b[key].dtype
            scale = max(1.0, float(a[key].abs().max()))
            torch.testing.assert_close(b[key].cpu(), a[key], rtol=0,
                                       atol=2e-5 * scale)


@pytest.mark.cuda
def test_cuda_xlstm_makes_no_host_sync(cuda):
    """Both kernels' wrappers, ``mlstm_apply`` and ``slstm_apply`` (prefill,
    and decode through their caches) on the card in bf16 under
    ``set_sync_debug_mode("error")``: nothing waits for the card
    (``jit_lint.SYNC_FREE`` names all four)."""
    from repro_torch.configs import get_config
    from repro_torch.models import xlstm
    from repro_torch.models.params import init_params
    cfg = get_config("xlstm-125m", smoke=True)
    gen = torch.Generator(cuda).manual_seed(3)
    pm, ps = (init_params(d(cfg), gen, torch.bfloat16, cuda)
              for d in (xlstm.mlstm_def, xlstm.slstm_def))
    cm, cs = (init_params(d(cfg, 3), gen, torch.bfloat16, cuda)
              for d in (xlstm.mlstm_cache_def, xlstm.slstm_cache_def))
    x = torch.randn((3, 20, cfg.d_model), device=cuda, dtype=torch.bfloat16)

    def run():
        ym, _ = xlstm.mlstm_apply(pm, x, cfg)
        ys, _ = xlstm.slstm_apply(ps, x, cfg)
        for t in range(3):
            dm, _ = xlstm.mlstm_apply(pm, x[:, t:t + 1], cfg, cache=cm)
            ds, _ = xlstm.slstm_apply(ps, x[:, t:t + 1], cfg, cache=cs)
        return ym, ys, dm, ds
    run()      # warm up (first launches, the libraries' load)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        outs = run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cm["C"].dtype == torch.float32 and cs["h"].dtype == torch.bfloat16
    assert all(bool(torch.isfinite(o).all()) for o in outs)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,carry", [(1, 300, False), (3, 257, True),
                                       (4, 1, True), (2, 0, True),
                                       (1, 4096, True), (2, 4096, True)],
                         ids=["prefill", "b3_carry", "decode", "empty",
                              "long_b1_carry", "long_b2_carry"])
def test_cuda_slstm_cluster_route_bitwise_block(cuda, B, S, carry):
    """bf16 at D = 768 takes the cluster route (16 blocks a batch row, rz
    in their registers, h handed over by st.async onto each block's
    mbarrier, no cluster barrier a step); it sums h @ rz in the block
    route's order, so its outputs and final carry are the block route's
    bit for bit, from zeros and from a carry, at B > 1, S = 1 and S = 0
    (the carry passed through). Three launches on the same inputs, each
    bitwise the block route and so each other: over 4,096 steps a hand-over
    read early or missed would show."""
    gz, gi, gf, go, rz, bf, c0 = _slstm_case(cuda, B, max(S, 1), 768,
                                             torch.bfloat16, carry, 3)
    gates = [g[:, :S] for g in (gz, gi, gf, go)]
    want_out = _empty_carry(B, 768, torch.bfloat16, cuda)
    want = ops.slstm_scan(*gates, rz, bf, c0, want_out, _route="block")
    runs = []
    for _ in range(3):
        out = _empty_carry(B, 768, torch.bfloat16, cuda)
        before = dict(ops.route_counts()["slstm_scan"])
        runs.append((ops.slstm_scan(*gates, rz, bf, c0, out), out))
        after = ops.route_counts()["slstm_scan"]
        assert after["cluster"] == before["cluster"] + 1
    for got, out in runs:
        assert torch.equal(got, want)
        for a, b in zip(out, want_out, strict=True):
            assert torch.equal(a, b)
    if carry and S == 0:
        for a, b in zip(runs[0][1], c0, strict=True):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_slstm_cluster_launch_refused_raises(cuda):
    """The cluster route's 16-block cluster is non-portable, so its launch
    asks the card whether it can place one and returns the error if not:
    the wrapper raises, counts no launch, and falls back to nothing. The
    route built at 32 blocks a cluster (``slstm_cluster32``), which no
    card places, is refused so; the runtime's error is cleared, so the
    next launch of the shipped route runs and is bitwise the block
    route."""
    gz, gi, gf, go, rz, bf, _ = _slstm_case(cuda, 1, 8, 768, torch.bfloat16,
                                            False, 4)
    args = (gz, gi, gf, go, rz, bf)
    before = ops.launch_counts()["slstm_scan"]
    routes = dict(ops.route_counts()["slstm_scan"])
    with pytest.raises(RuntimeError, match="slstm_scan: CUDA error"):
        ops.slstm_scan(*args, _build_name="slstm_cluster32")
    assert ops.launch_counts()["slstm_scan"] == before
    assert ops.route_counts()["slstm_scan"] == routes
    torch.cuda.synchronize()
    got = ops.slstm_scan(*args)
    assert torch.equal(got, ops.slstm_scan(*args, _route="block"))
