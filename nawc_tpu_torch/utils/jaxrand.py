"""``jax.random``'s threefry generator in numpy, bit for bit.

The spread-spectrum PN patterns are drawn with
``bernoulli(fold_in(PRNGKey(seed), b), 0.5, shape)``.  A mark made by one
package is readable by the other only if both draw the same bits, so this
module reproduces jax's threefry2x32 hash, ``PRNGKey``, ``fold_in``,
``split``, ``random_bits``, ``uniform``, ``normal``, ``bernoulli``,
``randint``, ``permutation`` and ``choice`` (without replacement) under
``jax_threefry_partitionable=True`` (the default of jax 0.9).  The keyed
attacks draw their noise here too, so that they draw what JAX draws.
Everything is uint32 and float32 arithmetic in numpy, on the host.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_U32 = np.uint32
_F32 = np.float32


def _rotl(x: np.ndarray, d: int) -> np.ndarray:
    return (x << _U32(d)) | (x >> _U32(32 - d))


def threefry2x32(key: np.ndarray, x1: np.ndarray, x2: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter pair (x1, x2)."""
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
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off (jax's default):
    the seed is cut to its low 32 bits, so the key is (0, seed mod 2**32)."""
    return np.array([0, int(seed) & 0xFFFFFFFF], _U32)


def _hash_words(key: np.ndarray, words: np.ndarray) -> np.ndarray:
    """``threefry_2x32(key, count)`` of jax's prng: the flat count is cut in
    two halves that form the counter pairs (padded with one 0 if odd)."""
    flat = np.asarray(words, _U32).ravel()
    odd = flat.size % 2
    if odd:
        flat = np.concatenate([flat, np.zeros(1, _U32)])
    h = flat.size // 2
    y1, y2 = threefry2x32(key, flat[:h], flat[h:])
    out = np.concatenate([y1, y2])
    return (out[:-1] if odd else out).reshape(np.shape(words))


def fold_in(key: np.ndarray, data: int) -> np.ndarray:
    """``jax.random.fold_in``: hash the key with the seed pair of `data`."""
    return _hash_words(key, prng_key(data))


def random_bits(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """32 random bits per element (the partitionable scheme: the counter is
    the element's row-major index as a (hi, lo) pair; bits = y1 ^ y2)."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    hi = (idx >> np.uint64(32)).astype(_U32)
    lo = (idx & np.uint64(0xFFFFFFFF)).astype(_U32)
    y1, y2 = threefry2x32(key, hi, lo)
    return (y1 ^ y2).reshape(shape)


def _unit_of_bits(bits: np.ndarray) -> np.ndarray:
    """float32 uniform in [0, 1): the 23 high bits of `bits` as the mantissa
    under exponent 0."""
    fbits = (np.asarray(bits, _U32) >> _U32(32 - 23)) | np.array(1.0, np.float32).view(_U32)
    return fbits.view(np.float32) - np.float32(1.0)


def _unit_uniform(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """float32 uniform in [0, 1) from 23 random mantissa bits."""
    return _unit_of_bits(random_bits(key, shape))


def _scaled(u: np.ndarray, minval, maxval) -> np.ndarray:
    """The unit uniform `u` over [minval, maxval): XLA on the CPU fuses
    ``u * (maxval - minval) + minval`` into one multiply-add (:func:`_fma`)."""
    lo, hi = _F32(minval), _F32(maxval)
    return np.maximum(lo, _fma(u, hi - lo, lo))


def uniform(key: np.ndarray, shape: tuple[int, ...], minval: float = 0.0,
            maxval: float = 1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _scaled(_unit_uniform(key, shape), minval, maxval)


def _fma(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` as XLA's CPU code contracts it: float64 holds
    the product of two float32 exactly, and the sum is rounded to float64,
    then to float32.  That double rounding equals one rounding of the exact
    ``a * b + c`` (a float32 fma) at every step over every input of
    :func:`normal_from_bits`, its 2^23 uniforms (shown in
    ``tests/test_torch_jaxrand.py``); over an arbitrary uniform range it is
    not shown, so the card's uniform draw keeps the float64 steps."""
    f64 = np.float64
    return (np.asarray(a, f64) * np.asarray(b, f64) + np.asarray(c, f64)).astype(_F32)


def _horner(x: np.ndarray, coeffs) -> np.ndarray:
    p = np.zeros_like(x)
    for c in coeffs:
        p = _fma(p, x, c)
    return p


# XLA's float32 log: Cephes' polynomial on the mantissa in [sqrt(1/2), sqrt(2))
_LOG_P = tuple(map(_F32, (7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
                          1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
                          3.3333331174e-1)))


def _log(v: np.ndarray) -> np.ndarray:
    """XLA's float32 log on the CPU for 0 < v < 1: Cephes' polynomial, each
    multiply-add fused or not as XLA's compiled code has it (found by
    comparison with it; it differs in about 5 of 10^6 arguments, by 1 ulp)."""
    m, e = np.frexp(v)
    m, e = m.astype(_F32), e.astype(_F32)
    small = m < _F32(0.707106781186547524)
    e = e - small.astype(_F32)
    x = (m - _F32(1)) + np.where(small, m, _F32(0))
    x2 = x * x
    x3 = x2 * x
    p = (x * _LOG_P[0] + _LOG_P[1]) * x + _LOG_P[2]
    p1 = (x * _LOG_P[3] + _LOG_P[4]) * x + _LOG_P[5]
    p2 = _fma(_fma(x, _LOG_P[6], _LOG_P[7]), x, _LOG_P[8])
    y = _fma(p * x3 + p1, x3, p2)
    y = _fma(y, x3, _F32(-2.12194440e-4) * e)
    return _fma(_F32(0.693359375), e, _fma(_F32(-0.5), x2, x) + y)


# XLA's float32 log1p for |x| < sqrt(2) - 1: Cephes' rational approximation
_LOG1P_NUM = tuple(map(_F32, (2.0039553499201281259648e1, 5.7112963590585538103336e1,
                              6.0949667980987787057556e1, 2.9911919328553073277375e1,
                              6.5787325942061044846969e0, 4.9854102823193375972212e-1,
                              4.5270000862445199635215e-5)))
_LOG1P_DEN = tuple(map(_F32, (6.0118660497603843919306e1, 2.1642788614495947685003e2,
                              3.0909872225312059774938e2, 2.2176239823732856465394e2,
                              8.3047565967967209469434e1, 1.5062909083469192043167e1, 1.0)))


def _log1p(x: np.ndarray) -> np.ndarray:
    """XLA's float32 log1p on the CPU for -1 < x <= 0."""
    x2 = x * x
    r = _horner(x, _LOG1P_NUM[::-1]) / _horner(x, _LOG1P_DEN[::-1])
    small = x + _fma(_F32(-0.5), x2, (x * x2) * r)
    with np.errstate(divide="ignore"):
        large = _log(_F32(1) + x)
    return np.where(np.abs(x) < _F32(0.41421356237309504880), small, large)


# Giles' coefficients of XLA's float32 erf_inv for w < 5 and w >= 5, lowest
# power first
_ERFINV_LO = tuple(map(_F32, (1.50140941, 0.246640727, -0.00417768164, -0.00125372503,
                              0.00021858087, -4.39150654e-06, -3.5233877e-06, 3.43273939e-07,
                              2.81022636e-08)))
_ERFINV_HI = tuple(map(_F32, (2.83297682, 1.00167406, 0.00943887047, -0.0076224613,
                              0.00573950773, -0.00367342844, 0.00134934322, 0.000100950558,
                              -0.000200214257)))


def erf_inv(x: np.ndarray) -> np.ndarray:
    """``jax.lax.erf_inv`` for float32 |x| < 1 as XLA computes it on the CPU
    (M. Giles, "Approximating the erfinv function", with its log1p and its
    multiply-adds).  Not ``torch.special.erfinv``: that one is closer to the
    true function, so it strays from XLA's values."""
    x = np.asarray(x, _F32)
    w = -_log1p(x * -x)
    lo = w < _F32(5.0)
    with np.errstate(invalid="ignore"):
        w = np.where(lo, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.zeros_like(x)
    for c_lo, c_hi in zip(_ERFINV_LO[::-1], _ERFINV_HI[::-1]):
        p = _fma(p, w, np.where(lo, c_lo, c_hi))
    return p * x


def normal_from_bits(bits: np.ndarray) -> np.ndarray:
    """The normal that ``jax.random.normal`` makes of 32 random bits (uint32):
    sqrt(2) erf_inv(u) of the uniform u in (-1, 1) of their 23 high bits."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _F32(np.sqrt(2)) * erf_inv(_scaled(_unit_of_bits(bits), lo, _F32(1.0)))


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``: :func:`normal_from_bits`
    of :func:`random_bits`; within 2 ulp of JAX's, equal in all but about
    one draw in 10^6 (see :func:`_log`)."""
    return normal_from_bits(random_bits(key, shape))


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split(key, num)`` -> (num, 2) uint32 keys: key i is the
    hash of the counter pair (0, i)."""
    y1, y2 = threefry2x32(key, np.zeros(num, _U32), np.arange(num, dtype=_U32))
    return np.stack([y1, y2], axis=-1)


def bernoulli(key: np.ndarray, p: float, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.bernoulli(key, p, shape)`` with a float32 `p`."""
    return _unit_uniform(key, shape) < np.float32(p)


def randint(key: np.ndarray, shape: tuple[int, ...], minval: int, maxval: int) -> np.ndarray:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32, `minval`
    and `maxval` within int32): two 32-bit draws per value, from the two
    halves of ``split(key)``, folded into the span as jax folds them, with
    uint32 wrap-around."""
    k1, k2 = split(key)
    hi, lo = random_bits(k1, shape), random_bits(k2, shape)
    span = _U32(1) if maxval <= minval else _U32((maxval - minval) & 0xFFFFFFFF)
    with np.errstate(over="ignore"):
        mult = _U32(2**16) % span
        mult = (mult * mult) % span
        off = ((hi % span) * mult + lo % span) % span
    return (np.int64(minval) + off.astype(np.int64)).astype(np.int32)


def permutation(key: np.ndarray, n: int) -> np.ndarray:
    """``jax.random.permutation(key, n)``: ``arange(n)`` (int32) shuffled by
    rounds of a stable sort keyed by 32 random bits, as jax's ``_shuffle``
    does; each round splits the key and draws with the second half."""
    x = np.arange(n, dtype=np.int32)
    # jax's round count: ceil(3 ln n / ln(2^32 - 1)), 2 rounds for n = 4096
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        key, sub = split(key)
        x = x[np.argsort(random_bits(sub, (n,)), kind="stable")]
    return x


def choice(key: np.ndarray, n: int, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.choice(key, n, shape, replace=False)``: the first
    ``prod(shape)`` entries of :func:`permutation`."""
    return permutation(key, n)[: int(np.prod(shape, dtype=np.int64))].reshape(shape)
