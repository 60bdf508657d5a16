"""flax's parameter initialisation in numpy, for random-weight
models that equal the JAX package's of the same seed.

``Module.init(PRNGKey(seed), ...)`` gives every parameter its own key:
flax 0.12 folds into the root key the first four bytes of a sha1 hash of
the parameter's module path and its scope's draw counter
(``flax/core/scope.py``: ``LazyRng.as_jax_rng``, ``_fold_in_static``).
The initialisers then draw from that key with ``jax.random``: uniform bits
from threefry (:mod:`.jaxrand`, bit for bit), mapped through ``erf_inv``.

``erf_inv`` here is XLA's own float32 approximation (M. Giles,
"Approximating the erfinv function", as XLA lowers ``chlo.erf_inv``) in
numpy float32, not ``torch.special.erfinv``: that one is closer to the
true function, so near |u| = 1 it strays from XLA's values by more than the
1e-6 the weights are held to.  The replica differs from XLA only where
numpy's log1p or sqrt rounds otherwise.
"""

from __future__ import annotations

import hashlib
import math

import numpy as np

from . import jaxrand

_F32 = np.float32
# stddev of a standard normal truncated to (-2, 2) (jax.nn.initializers)
_TRUNC2_STD = _F32(0.87962566103423978)


def param_key(root: np.ndarray, path: tuple[str, ...], count: int = 1) -> np.ndarray:
    """The key flax hands the initialiser of a parameter: `path` is its
    module path (e.g. ``("encoder", "Conv_0")``), `count` the number of the
    draw in that module's scope (1 for the first parameter it declares)."""
    m = hashlib.sha1()
    for x in (*path, count):
        if isinstance(x, str):
            m.update(x.encode("utf-8"))
        else:
            m.update(x.to_bytes((x.bit_length() + 7) // 8, byteorder="big"))
    return jaxrand.fold_in(root, int.from_bytes(m.digest()[:4], byteorder="big"))


# Giles' coefficients for w < 5 and w >= 5, highest power first
_ERFINV_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
              0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
              0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erf_inv(x: np.ndarray) -> np.ndarray:
    """``jax.lax.erf_inv`` for float32 |x| < 1, step for step."""
    x = np.asarray(x, _F32)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = -np.log1p(x * -x)
        lo = w < _F32(5.0)
        w = np.where(lo, w - _F32(2.5), np.sqrt(w) - _F32(3.0))
    p = np.zeros_like(x)
    for c_lo, c_hi in zip(_ERFINV_LO, _ERFINV_HI):
        p = np.where(lo, _F32(c_lo), _F32(c_hi)) + p * w
    return p * x


def _uniform(key: np.ndarray, shape: tuple[int, ...], lo: np.float32, hi: np.float32) -> np.ndarray:
    """``jax.random.uniform(key, shape, float32, lo, hi)``.  XLA on the CPU
    fuses ``u * (hi - lo) + lo`` into one multiply-add, rounded once; float64
    holds the product of two float32 exactly, so this rounds as it does."""
    u = jaxrand.uniform(key, shape).astype(np.float64)
    return np.maximum(lo, (u * np.float64(hi - lo) + np.float64(lo)).astype(_F32))


def normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.normal(key, shape, float32)``."""
    lo = np.nextafter(_F32(-1.0), _F32(0.0))
    return _F32(np.sqrt(2)) * erf_inv(_uniform(key, shape, lo, _F32(1.0)))


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``."""
    sqrt2 = _F32(np.sqrt(2))
    lo, hi = _F32(lower), _F32(upper)
    # XLA's float32 erf agrees with the rounded true value at +-sqrt(2)
    a, b = (_F32(math.erf(float(v / sqrt2))) for v in (lo, hi))
    out = sqrt2 * erf_inv(_uniform(key, shape, a, b))
    return np.clip(out, np.nextafter(lo, _F32(np.inf)), np.nextafter(hi, _F32(-np.inf)))


def _fan_in(shape: tuple[int, ...]) -> int:
    """jax's fan-in with in_axis -2 and out_axis -1: the input width times
    the receptive field."""
    return int(np.prod(shape[:-1]))


def lecun_normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """flax's default kernel init, ``variance_scaling(1, "fan_in",
    "truncated_normal")``."""
    std = np.sqrt(_F32(1.0 / _fan_in(shape))) / _TRUNC2_STD
    return truncated_normal(key, -2.0, 2.0, shape) * std


def fan_in_normal(key: np.ndarray, shape: tuple[int, ...]) -> np.ndarray:
    """``variance_scaling(1.0, "fan_in", "normal")``."""
    return normal(key, shape) * np.sqrt(_F32(1.0 / _fan_in(shape)))
