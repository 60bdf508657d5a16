"""Fused whiten+correlate for the spread-spectrum detector
(``nawc_tpu/ops/sswm.py``): the CUDA kernel ``csrc/sswm.cu`` and its plain
PyTorch versions.

Given the band residual r (B, T, W) the detector per-bin whitens over time
and correlates against the K secret PN patterns plus time-rolled null
variants.  The patterns are time-centred, so the whitening reduces to a
per-bin scaling (see the JAX module's docstring):
    sum_tw ((r - mu_w - c) / s_w) p = sum_tw (r / s_w) p.

* :func:`whiten_correlate_reference` is the original detector math, kept
  verbatim as the exactness oracle.
* :func:`_whiten_correlate_plain` (the JAX package's ``_whiten_correlate_xla``)
  scales r, then contracts it with the stacked pattern variants in one einsum.
  It is the CPU path and the kernel's plain version.
* The kernel (four launches from one C entry: per-bin statistics, the
  tiled contraction, a fixed-order reduction, z) reads the raw
  patterns: the scaled residual has zero time-sum per bin, so centring the
  patterns changes no correlation.  It never builds the rolled stack.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "whiten_correlate", "nawc_whiten_correlate",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p],
))
_SCRATCH = _lib.CEntry(
    "whiten_correlate scratch", "nawc_whiten_correlate_scratch",
    [ctypes.c_int] * 5 + [ctypes.POINTER(ctypes.c_size_t)],
)


def _center_time(p: torch.Tensor) -> torch.Tensor:
    return p - p.mean(dim=-2, keepdim=True)


def whiten_correlate_reference(
    r: torch.Tensor, p: torch.Tensor, null_offsets: tuple[int, ...]
) -> torch.Tensor:
    """(B, T, W) residual, (K, T, W) patterns -> (B, K) calibrated z stats."""
    mu = r.mean(dim=-2, keepdim=True)
    sd = r.std(dim=-2, keepdim=True, correction=0)
    rw = (r - mu) / (sd + 0.2)
    pc = _center_time(p)
    rw = rw - rw.mean(dim=(-2, -1), keepdim=True)
    corr = torch.einsum("btw,ktw->bk", rw, pc)
    nulls = torch.stack(
        [torch.einsum("btw,ktw->bk", rw, torch.roll(pc, o, dims=-2)) for o in null_offsets],
        dim=-1,
    )
    sigma = torch.sqrt((nulls**2).mean(dim=(-2, -1)))
    return corr / (sigma[:, None] + 1e-8)


def _pattern_stack(p: torch.Tensor, null_offsets: tuple[int, ...]) -> torch.Tensor:
    """(K, T, W) -> (NV, K, T, W): the time-centred patterns, then their
    cyclic time rolls."""
    pc = _center_time(p)
    return torch.stack([pc] + [torch.roll(pc, o, dims=-2) for o in null_offsets])


def _scale_shift(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, T, W) -> per-bin scale 1/(std_t + 0.2) and scaled mean, (B, 1, W).
    ``jnp.std`` is the population std, hence ``correction=0``."""
    mu = r.mean(dim=-2, keepdim=True)
    sd = r.std(dim=-2, keepdim=True, correction=0)
    scale = 1.0 / (sd + 0.2)
    return scale, mu * scale


def _calibrate(corr_all: torch.Tensor) -> torch.Tensor:
    """(B, NV, K) variant correlations -> (B, K) z statistics."""
    corr, nulls = corr_all[:, 0], corr_all[:, 1:]
    sigma = torch.sqrt((nulls**2).mean(dim=(-2, -1)))
    return corr / (sigma[:, None] + 1e-8)


def _whiten_correlate_plain(
    r: torch.Tensor, p: torch.Tensor, null_offsets: tuple[int, ...]
) -> torch.Tensor:
    pstack = _pattern_stack(p, null_offsets)
    scale, shift = _scale_shift(r)
    rs = r * scale - shift
    return _calibrate(torch.einsum("btw,jktw->bjk", rs, pstack))


def _whiten_correlate_cuda(
    r: torch.Tensor, p: torch.Tensor, null_offsets: tuple[int, ...]
) -> torch.Tensor:
    """(B, T, W), (K, T, W) -> (B, K) z by the kernel."""
    b, t, w = r.shape
    k = p.shape[0]
    if p.shape[1:] != (t, w):
        raise ValueError(f"whiten_correlate: patterns {tuple(p.shape)} do not match r {tuple(r.shape)}")
    offs = (0,) + tuple(int(o) % t for o in null_offsets)
    r = r.float().contiguous()
    p = p.float().contiguous()
    _lib.check_cuda_f32("whiten_correlate", r, p)
    z = torch.empty((b, k), device=r.device, dtype=torch.float32)
    # csrc/sswm.cu refuses (cudaErrorInvalidValue) shapes and rolls beyond its limits
    offs_c = (ctypes.c_int * len(offs))(*offs)
    floats = ctypes.c_size_t()
    with torch.cuda.device(r.device):
        _SCRATCH(b, t, w, k, len(offs), ctypes.byref(floats))
        scratch = torch.empty(floats.value, device=r.device, dtype=torch.float32)
        _KERNEL(_lib.ptr(r), _lib.ptr(p), _lib.ptr(scratch), _lib.ptr(z), b, t, w, k, offs_c,
                len(offs), _lib.stream(r))
    return z


class _WhitenCorrelateKernel(torch.autograd.Function):
    """The kernel's forward with the plain version's gradient, as the JAX
    package pairs its Pallas forward with the XLA path's VJP
    (``nawc_tpu/ops/sswm.py: _whiten_correlate_hybrid``): both compute the
    same function, so the plain VJP is the kernel's.  There is no backward
    kernel, as there is none in the JAX package."""

    @staticmethod
    def forward(ctx, r, p, null_offsets):
        ctx.null_offsets = null_offsets
        ctx.save_for_backward(r, p)
        return _whiten_correlate_cuda(r, p, null_offsets)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        r, p = ctx.saved_tensors
        need = ctx.needs_input_grad[:2]
        with torch.enable_grad():
            r_, p_ = (x.detach().requires_grad_(n) for x, n in zip((r, p), need))
            z = _whiten_correlate_plain(r_, p_, ctx.null_offsets)
            grads = iter(torch.autograd.grad(z, [x for x in (r_, p_) if x.requires_grad], g))
        return (next(grads) if need[0] else None), (next(grads) if need[1] else None), None


def whiten_correlate(
    r: torch.Tensor,
    p: torch.Tensor,
    null_offsets: tuple[int, ...],
) -> torch.Tensor:
    """Self-calibrated detector statistics.

    Args:
      r: (B, T, W) band residual (log-magnitude minus spectral envelope).
      p: (K, T, W) +-1 PN patterns, already tiled to T frames.
      null_offsets: frame rolls whose correlations sample the null; on the
        card at most 7, each taken mod T and at most 224 there.

    Returns:
      (B, K) z statistics, ~N(0, 1) per bit on unmarked audio.  On the
      card, where r or p requires grad, z carries the plain version's
      gradient (:class:`_WhitenCorrelateKernel`).
    """
    null_offsets = tuple(null_offsets)
    if _lib.use_kernel(r):
        if torch.is_grad_enabled() and (r.requires_grad or p.requires_grad):
            return _WhitenCorrelateKernel.apply(r, p, null_offsets)
        return _whiten_correlate_cuda(r, p, null_offsets)
    return _whiten_correlate_plain(r, p, null_offsets)


def bound_counts(b: int, t: int, w: int, k: int, n_variants: int) -> tuple[float, float, float]:
    """-> (bytes, f32 flops, TF32 tensor-core flops) that ``whiten_correlate``
    needs at these shapes: r, the patterns and z once each; per residual cell
    a sum and a sum of squares for the per-bin statistics (f32); and NV
    multiply-adds per (b, k, t, w), which the kernel runs on the tensor cores
    as three TF32 passes (the hi/lo split that keeps f32 accuracy).  The
    scaled residual has zero time mean per bin, so centring the patterns
    changes no correlation and is not counted."""
    nbytes = 4.0 * (b * t * w + k * t * w + b * k)
    flops = 3.0 * b * t * w
    tf32_flops = 3 * 2.0 * n_variants * b * k * t * w
    return nbytes, flops, tf32_flops
