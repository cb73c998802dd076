"""The reference's uniform draw, bit for bit, in numpy.

``uniform(seed, shape, dtype)`` gives what ``jax.random.uniform(
jax.random.PRNGKey(seed), shape, dtype)`` gives under JAX's default
threefry2x32 generator with partitionable keys (JAX >= 0.5's default):
the key is the two 32-bit words ``(seed >> 32, seed & 0xFFFFFFFF)``; the
counters are ``arange(size)`` split into high and low words; one
threefry2x32 hash of each counter gives two words, combined into 64 random
bits as ``hi << 32 | lo`` or into 32 as ``hi ^ lo``; the top mantissa bits
under the exponent of 1.0 give a float in [1, 2), less 1, then ``max(0,
.)``. The port's SIR seeding draws its fallback priorities from it
(``core/seeding.py::sir_seed``), so a seed gives the reference's
priorities on any device.
"""
from __future__ import annotations

import math

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: (float dtype, matching unsigned dtype, random bits, mantissa bits)
_FORMATS = {np.dtype(np.float64): (np.uint64, 64, 52),
            np.dtype(np.float32): (np.uint32, 32, 23)}


def _rotl(x, r: int):
    return (x << np.uint32(r)) | (x >> np.uint32(32 - r))


def threefry2x32(key, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``(x0,
    x1)`` under the key words ``key``: uint32 arrays in, two out."""
    k0, k1 = (np.uint32(k) for k in key)
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    x0 = x0 + ks[0]
    x1 = x1 + ks[1]
    for step in range(5):
        for r in _ROTATIONS[step % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(step + 1) % 3]
        x1 = x1 + ks[(step + 2) % 3] + np.uint32(step + 1)
    return x0, x1


def random_bits(seed: int, shape, bits: int):
    """``bits``-wide (32 or 64) random words of ``shape`` from the key
    ``PRNGKey(seed)``, as the partitionable threefry layout draws them."""
    seed = int(seed) & 0xFFFFFFFFFFFFFFFF
    key = (seed >> 32, seed & 0xFFFFFFFF)
    count = np.arange(math.prod(shape), dtype=np.uint64)
    with np.errstate(over="ignore"):
        hi, lo = threefry2x32(key, (count >> np.uint64(32)).astype(np.uint32),
                              count.astype(np.uint32))
    if bits == 64:
        out = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    else:
        out = hi ^ lo
    return out.reshape(shape)


def uniform(seed: int, shape, dtype=np.float64):
    """Uniform floats in [0, 1) of ``shape``, equal bit for bit to
    ``jax.random.uniform(PRNGKey(seed), shape, dtype)``; float64 or
    float32."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    dtype = np.dtype(dtype)
    if dtype not in _FORMATS:
        raise TypeError(f"uniform takes float64 or float32, got {dtype}")
    uint, nbits, nmant = _FORMATS[dtype]
    bits = random_bits(seed, shape, nbits).astype(uint)
    one = np.array(1.0, dtype).view(uint)
    floats = ((bits >> uint(nbits - nmant)) | one).view(dtype) - dtype.type(1)
    return np.maximum(dtype.type(0), floats)
