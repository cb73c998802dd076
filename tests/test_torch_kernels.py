"""The port's kernels against the JAX reference's, on the CPU.

On a CPU tensor each wrapper runs its plain PyTorch version; these tests
hold those to the reference's Pallas kernels (run in interpret mode, as the
reference's own tests run them here) and to its jnp oracles, at the
reference's bars (``tests/test_kernels.py``). The CUDA kernels themselves
are held to the plain versions on the card (``test_torch_cuda.py`` and
``chip_smoke.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rbf import rbf_kernel_matrix as pallas_rbf
from repro.kernels.ref import rbf_kernel_matrix_ref as jnp_rbf_ref
from repro.kernels.ref import smo_f_update_ref as jnp_fupdate_ref
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


def test_cpu_tensors_launch_no_kernel():
    ops.reset_launch_counts()
    X = torch.from_numpy(RNG.normal(size=(20, 5)))
    K = ops.rbf_kernel_matrix(X, X, 0.5)
    ops.smo_f_update(K[0], K[1], K[2], 0.1)
    n = K.shape[0]
    ops.smo_chunk(K, torch.diagonal(K).contiguous(),
                  torch.where(torch.arange(n) % 2 == 0, 1.0, -1.0).double(),
                  torch.ones(n, dtype=torch.bool), 1.0, 1e-3, 100, 5, "2",
                  torch.zeros(n, dtype=torch.float64), -torch.ones(n).double(),
                  torch.tensor(0), torch.tensor(False))
    assert ops.launch_counts() == {"rbf_kernel_matrix": 0,
                                   "smo_f_update": 0, "smo_chunk": 0}


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
