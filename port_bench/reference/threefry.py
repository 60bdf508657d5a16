"""``jax.random``'s threefry bits in numpy, as far as the watermarks' PN
sequences need them: ``PRNGKey``, ``fold_in`` and ``bernoulli`` under the
partitionable scheme (jax's default).  A frozen copy, kept with the
reference so that it depends on nothing of the measured program."""

from __future__ import annotations

import numpy as np

_U32 = np.uint32
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d):
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key, x1, x2):
    """Threefry-2x32, 20 rounds, of the counter pairs (x1, x2)."""
    k1, k2 = _U32(key[0]), _U32(key[1])
    ks = (k1, k2, k1 ^ k2 ^ _U32(0x1BD11BDA))
    x = [np.asarray(x1, _U32) + ks[0], np.asarray(x2, _U32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r)
                x[1] = x[0] ^ x[1]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + _U32(i + 1)
    return x[0], x[1]


def prng_key(seed: int) -> np.ndarray:
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def fold_in(key, data: int) -> np.ndarray:
    """Hash of the key with the pair (0, data), counters split in halves."""
    y1, y2 = threefry2x32(key, np.array([0], _U32), np.array([int(data) & 0xFFFFFFFF], _U32))
    return np.array([y1[0], y2[0]], _U32)


def bernoulli(key, p: float, shape) -> np.ndarray:
    """True where the float32 uniform of 23 random mantissa bits is below p."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    y1, y2 = threefry2x32(key, (idx >> np.uint64(32)).astype(_U32),
                          (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    bits = (y1 ^ y2) >> _U32(9)
    u = (bits | np.array(1.0, np.float32).view(_U32)).view(np.float32) - np.float32(1.0)
    return (u < np.float32(p)).reshape(shape)
