"""Keyed draws of ``jax.random`` where their consumer lies: ``normal`` and
``uniform`` over a :mod:`..utils.jaxrand` key, into a float32 tensor on
`device`.  On a CUDA device the kernel ``csrc/jaxrand.cu`` computes them
(bit for bit the replica's values) or the call raises; on the CPU, and
under :func:`._lib.plain_versions`, they are the numpy replica's draws,
which is this kernel's plain version.  The key stays a host (2,) uint32
array: ``split`` and ``fold_in`` are one hash each.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils import jaxrand
from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "jaxrand", "nawc_jaxrand",
    [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint32, ctypes.c_uint32, ctypes.c_int,
     ctypes.c_float, ctypes.c_float, ctypes.c_void_p],
))
_F32 = np.float32
# the range of the uniform under jaxrand.normal
_NORMAL_LO, _NORMAL_HI = np.nextafter(_F32(-1.0), _F32(0.0)), _F32(1.0)


def _draw(key: np.ndarray, shape, device, normal: bool, minval, maxval) -> torch.Tensor:
    shape = tuple(int(s) for s in shape)
    if np.shape(key) != (2,):
        raise ValueError(f"jaxrand: a key is a (2,) uint32 array, got shape {np.shape(key)}")
    out = torch.empty(shape, dtype=torch.float32, device=device)
    if not _lib.use_kernel(out):
        host = jaxrand.normal(key, shape) if normal else jaxrand.uniform(key, shape, minval, maxval)
        return out.copy_(torch.from_numpy(host))
    if out.numel():
        lo, hi = _F32(minval), _F32(maxval)
        with torch.cuda.device(out.device):
            _KERNEL(_lib.ptr(out), out.numel(), int(key[0]), int(key[1]), int(normal), float(lo),
                    float(hi - lo), _lib.stream(out))
    return out


def normal(key: np.ndarray, shape, device) -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)`` on `device`."""
    return _draw(key, shape, device, True, _NORMAL_LO, _NORMAL_HI)


def uniform(key: np.ndarray, shape, device, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)`` on `device`."""
    return _draw(key, shape, device, False, minval, maxval)


def bound_counts(n: int, normal: bool = False, n_log1p_rational: int = 0) -> tuple[float, float, float, float]:
    """-> (bytes, int32 operations, fp64 operations, f32 operations) that
    `n` draws need: the output written once; the hash's 75 integer
    operations per draw (20 rounds of add, rotate and xor, the key
    injections, the mantissa); the float64 multiply and add of each
    rounded-once step.  A normal draw takes log1p's rational branch
    (`n_log1p_rational` of the `n`, where |u|^2 < sqrt(2) - 1) or its log."""
    f64 = 2.0 * n
    f32 = 2.0 * n
    if normal:
        rational = float(n_log1p_rational)
        f64 += 18.0 * n + 30.0 * rational + 12.0 * (n - rational)
        f32 += 5.0 * n + 5.0 * rational + 15.0 * (n - rational)
    return 4.0 * n, 75.0 * n, f64, f32
