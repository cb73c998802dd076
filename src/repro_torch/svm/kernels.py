"""Kernel functions. Mirrors ``src/repro/svm/kernels.py``.

The RBF goes through ``kernels/rbf.py``: the hand-written kernel for a CUDA
tensor, the plain PyTorch expression for a CPU tensor. There is no backend
option: the tensor's device decides.
"""
from __future__ import annotations

from repro_torch.kernels.ops import rbf_kernel_matrix


def rbf_kernel(X, Z, gamma: float):
    """K[i,j] = exp(-gamma * ||x_i - z_j||^2), shapes (n,d),(m,d) -> (n,m)."""
    return rbf_kernel_matrix(X, Z, gamma)


def linear_kernel(X, Z, gamma: float = 0.0):
    del gamma
    return X @ Z.T


_KERNELS = {"rbf": rbf_kernel, "linear": linear_kernel}


def kernel_matrix(X, Z, *, kind: str = "rbf", gamma: float = 1.0):
    """Full kernel matrix of ``kind`` ('rbf' or 'linear')."""
    return _KERNELS[kind](X, Z, gamma)
