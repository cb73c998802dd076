"""Synthetic stand-ins for the paper's five LibSVM datasets.

Mirrors ``src/repro/data/svm_suite.py``. The port keeps its own copy of this
numpy-only module so that it imports nothing of the JAX package; the tests
hold the copy to the original bit for bit (X, y and ``kfold_chunks``).

The container is offline, so Adult/Heart/Madelon/MNIST/Webdata cannot be
downloaded. We generate binary tasks with the paper's dimensionalities and
hyper-parameters (Table 2); the three large sets are cardinality-scaled to a
CPU budget (paper claims are about iteration counts / identical fixed points,
which are scale-invariant — see DESIGN.md §Synthetic datasets).

Generator: two anisotropic Gaussian clusters over ``n_informative`` dims,
remaining dims pure noise (Madelon-style), plus label noise ``flip``.
Deterministic per (name, seed) so any worker can regenerate any shard
(straggler/fault-tolerance property — no data state to lose).
"""
from __future__ import annotations

import dataclasses
import zlib

import numpy as np


@dataclasses.dataclass(frozen=True)
class SVMDataset:
    name: str
    X: np.ndarray          # (n, d) float64
    y: np.ndarray          # (n,) {-1, +1}
    C: float
    gamma: float

    @property
    def n(self):
        return self.X.shape[0]


# name -> (cardinality, dim, C, gamma, n_informative, separation, flip,
#          balanced)
# C/gamma are the paper's Table 2 values. ``cardinality`` for the three large
# sets is scaled (paper sizes in comments). separation/flip are tuned so each
# synthetic task lands in the same SVM *regime* as its namesake — the paper's
# reported CV accuracies expose those regimes: Madelon 50.0% and MNIST 50.85%
# are chance level (K ~= I, alphas ~ all bounded at C), Heart 55.6% is near
# chance (huge C=2182), Adult 82.4% mixed, Webdata 97.7% near separable.
# ``balanced`` gives an exact 50/50 label split (real Madelon is 1000/1000),
# which determines the equality-multiplier nu and hence the bounded/free SV
# split that alpha seeding is sensitive to.
SPECS = {
    "adult":   (2000, 123, 100.0, 0.5, 40, 1.3, 0.10, False),   # paper: 32,561
    "heart":   (270, 13, 2182.0, 0.2, 10, 0.35, 0.30, False),   # paper size
    "madelon": (2000, 500, 1.0, 0.7071, 0, 0.0, 0.0, True),     # paper size
    "mnist":   (2000, 780, 10.0, 0.125, 60, 0.15, 0.40, True),  # paper: 60,000
    "webdata": (2000, 300, 64.0, 7.8125, 30, 2.2, 0.015, False),  # paper: 49,749
}
DATASETS = tuple(SPECS)


def make_dataset(name: str, *, seed: int = 0, n_override: int | None = None) -> SVMDataset:
    n, d, C, gamma, n_inf, sep, flip, balanced = SPECS[name]
    if n_override is not None:
        n = n_override
    # crc32, NOT hash(): str hashing is salted per process (PYTHONHASHSEED),
    # which silently broke the "any worker can regenerate any shard" property
    # and made cross-process results (tests, benchmarks) non-reproducible
    rng = np.random.default_rng(zlib.crc32(f"{name}:{seed}".encode()))
    if balanced:
        y = np.repeat([1, -1], [n - n // 2, n // 2])
        y = y[rng.permutation(n)]
    else:
        y = np.where(rng.random(n) < 0.5, 1, -1)
    X = rng.normal(size=(n, d))
    if n_inf > 0:
        # class-dependent mean shift on informative dims, anisotropic scale
        centers = rng.normal(size=(2, n_inf)) * sep
        scales = 0.5 + rng.random(n_inf)
        X[:, :n_inf] = X[:, :n_inf] * scales + np.where(y[:, None] > 0,
                                                        centers[0], centers[1])
    # label noise makes the task non-separable (drives bounded SVs, like Adult)
    flip_mask = rng.random(n) < flip
    y = np.where(flip_mask, -y, y)
    # feature scaling to [-1, 1] (LibSVM convention; keeps gamma meaningful)
    X = X / (np.abs(X).max(axis=0, keepdims=True) + 1e-12)
    return SVMDataset(name=name, X=X.astype(np.float64), y=y.astype(np.int64),
                      C=C, gamma=gamma)


def kfold_chunks(n: int, k: int, *, seed: int = 0) -> np.ndarray:
    """Shuffled indices split into k equal chunks, shape (k, n//k).

    Instances beyond k*(n//k) are dropped (static shapes: one compiled solver
    serves all folds). Chunk h is fold h's test set.

    Indices are a permutation of range(k*(n//k)) — the same range callers
    slice their arrays to. (Permuting range(n) and truncating, as this used
    to do, leaves indices >= k*(n//k) in the chunks whenever k does not
    divide n; jax's clamping scatter then silently corrupted that fold's
    train mask. For k | n the draw is unchanged.)
    """
    rng = np.random.default_rng(seed)
    m = n // k
    return rng.permutation(k * m).reshape(k, m)
