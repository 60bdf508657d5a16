"""Keyed draws of ``jax.random`` where their consumer lies: ``normal`` and
``uniform`` over a :mod:`..utils.jaxrand` key, into a float32 tensor on
`device`.  On a CUDA device the kernel ``csrc/jaxrand.cu`` computes them
(bit for bit the replica's values) or the call raises; on the CPU, and
under :func:`._lib.plain_versions`, they are the numpy replica's draws,
which is this kernel's plain version.  The key stays a host (2,) uint32
array: ``split`` and ``fold_in`` are one hash each.

:func:`normal_of_bits` runs the normal draw's transform on given bits, so
that the card can be held against the replica over the transform's whole
domain (2^23 uniforms); no path calls it.
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
# a check's entry, on no path: counted apart from the path's kernels
_BITS_KERNEL = _lib.CudaKernel(
    "jaxrand normal_of_bits", "nawc_jaxrand_normal_of_bits",
    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p],
)
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


def normal_of_bits(bits: torch.Tensor) -> torch.Tensor:
    """The normal of each of the 32-bit patterns `bits` (an int32 tensor,
    read as uint32): :func:`..utils.jaxrand.normal_from_bits`, by the keyed
    normal draw's device code on a CUDA tensor -> float32 of its shape."""
    if bits.dtype != torch.int32:
        raise ValueError(f"normal_of_bits: expected int32 bits, got {bits.dtype}")
    if not _lib.use_kernel(bits):
        host = jaxrand.normal_from_bits(bits.detach().cpu().numpy().view(np.uint32))
        return torch.from_numpy(host).to(bits.device)
    bits = bits.contiguous()
    out = torch.empty(bits.shape, dtype=torch.float32, device=bits.device)
    if out.numel():
        with torch.cuda.device(out.device):
            _BITS_KERNEL(_lib.ptr(out), _lib.ptr(bits), out.numel(), _lib.stream(out))
    return out


def bound_counts(n: int, normal: bool = False, n_log1p_rational: int = 0) -> tuple[float, float, float, float]:
    """-> (bytes, int32 operations, fp64 instructions, f32 instructions)
    that `n` draws need: the output written once; the hash's 75 integer
    operations per draw (20 rounds of add, rotate and xor, the key
    injections, the mantissa); the FMA-unit instructions (an add, a
    multiply or a fused multiply-add is one, and runs at half the data
    sheet's FLOP/s).  A uniform draw spends a float64 multiply and add
    (its rounded-once step) and one float32 add; a normal draw spends
    float32 only: 15 for its uniform, erf_inv and scale, then 20 on
    log1p's rational branch (`n_log1p_rational` of the `n`, where
    |u|^2 < sqrt(2) - 1) or 24 on its log."""
    if not normal:
        return 4.0 * n, 75.0 * n, 2.0 * n, 1.0 * n
    rational = float(n_log1p_rational)
    return 4.0 * n, 75.0 * n, 0.0, 15.0 * n + 20.0 * rational + 24.0 * (n - rational)
