"""The JAX package's random initial params from a seed, without JAX.

JAX draws its keys and uniforms with Threefry-2x32 (Salmon et al., SC'11),
in its partitionable form (``jax_threefry_partitionable``, JAX's default):
a key is two uint32 words, ``jax.random.key(seed)`` is (0, seed mod 2^32),
``split(key, n)`` hashes the counters (0, i) for i < n, and
``uniform`` hashes the counters (i >> 32, i & 0xFFFFFFFF) of each element's
flat index i, xors the two output words, keeps 23 of their bits as the
mantissa of a float in [1, 2), and maps it onto [minval, maxval) with one
fused multiply-add. This module does the same in numpy, on the host, so
that the port's Trainer starts from the params the JAX package's Trainer
starts from for the same seed (rainbow_tpu/train.py:532-534,
rainbow_tpu/agent.py:61-64, rainbow_tpu/models/dqn.py:35-66). The port's
later draws (noise, replay uniforms) stay its own.
"""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32


def threefry2x32(k1, k2, x1, x2):
    """Threefry-2x32, 20 rounds, of the counter pairs (x1, x2) under the key
    (k1, k2), all uint32; returns the two output words."""
    ks = (_U32(k1), _U32(k2), _U32(k1) ^ _U32(k2) ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = ((x[1] << _U32(r)) | (x[1] >> _U32(32 - r))) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def key(seed: int) -> tuple:
    """``jax.random.key(seed)``'s two words: JAX, outside its 64-bit mode,
    keeps the seed's low 32 bits."""
    return _U32(0), _U32(seed & 0xFFFFFFFF)


def split(k: tuple, n: int) -> list:
    """``jax.random.split(k, n)``: n keys."""
    b1, b2 = threefry2x32(*k, np.zeros(n, _U32), np.arange(n, dtype=_U32))
    return list(zip(b1, b2))


def uniform(k: tuple, shape: tuple, minval: float,
            maxval: float) -> np.ndarray:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``, bit for
    bit."""
    i = np.arange(int(np.prod(shape)), dtype=np.uint64)
    b1, b2 = threefry2x32(*k, (i >> np.uint64(32)).astype(_U32),
                          (i & np.uint64(0xFFFFFFFF)).astype(_U32))
    unit = (((b1 ^ b2) >> _U32(9)) | _U32(0x3F800000)).view(np.float32) - 1
    lo, hi = np.float32(minval), np.float32(maxval)
    # One rounding, as XLA's fused multiply-add: the float64 product of two
    # float32 values is exact.
    out = (unit.astype(np.float64) * np.float64(hi - lo)
           + np.float64(lo)).astype(np.float32)
    return np.maximum(lo, out).reshape(shape)
