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
    X = torch.from_numpy(RNG.normal(size=(257, 70))).to(cuda, dtype)
    Z = torch.from_numpy(RNG.normal(size=(130, 70))).to(cuda, dtype)
    want = ref.rbf_kernel_matrix_ref(X, Z, 0.37)
    for tile in (64, 32):
        got = ops.rbf_kernel_matrix(X, Z, 0.37, _tile=tile)
        torch.testing.assert_close(got, want, rtol=0, atol=atol)


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
    """At n=3000 the one-block kernel's 1024 threads each stride over
    three rows, so its per-thread (value, index) accumulation runs; the
    run stops at it_cap, so the cap's freeze is compared too."""
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
    got = ops.smo_chunk(*args, *state)
    assert int(got[2]) == 200 and bool(got[3])
    for a, b in zip(got, plain):
        assert torch.equal(a, b)
