"""flax's parameter initialisation in numpy, for random-weight
models that equal the JAX package's of the same seed.

``Module.init(PRNGKey(seed), ...)`` gives every parameter its own key:
flax 0.12 folds into the root key the first four bytes of a sha1 hash of
the parameter's module path and its scope's draw counter
(``flax/core/scope.py``: ``LazyRng.as_jax_rng``, ``_fold_in_static``).
The initialisers then draw from that key with ``jax.random``: uniform bits
from threefry mapped through XLA's float32 ``erf_inv``, both reproduced by
:mod:`.jaxrand`.
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


def truncated_normal(key: np.ndarray, lower: float, upper: float,
                     shape: tuple[int, ...]) -> np.ndarray:
    """``jax.random.truncated_normal(key, lower, upper, shape, float32)``."""
    sqrt2 = _F32(np.sqrt(2))
    lo, hi = _F32(lower), _F32(upper)
    # XLA's float32 erf agrees with the rounded true value at +-sqrt(2)
    a, b = (_F32(math.erf(float(v / sqrt2))) for v in (lo, hi))
    out = sqrt2 * jaxrand.erf_inv(jaxrand.uniform(key, shape, a, b))
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
    return jaxrand.normal(key, shape) * np.sqrt(_F32(1.0 / _fan_in(shape)))
