"""The Snake activation, ``x + sin^2(alpha x) / (alpha + 1e-9)`` with the
JAX package's range-reduced Taylor-7 sin^2 (``nawc_tpu/codec/layers.py``),
forward and backward: the CUDA kernel ``csrc/snake.cu`` and its plain
PyTorch versions.

* :func:`snake_reference` is the plain forward, the body ``Snake.forward``
  had before the kernel: the CPU path, and the plain version on the card.
* :func:`snake_backward_reference` is the kernel's backward, step for step
  in PyTorch, so that the CPU tests reach the kernel's arithmetic.
* :func:`snake` runs the kernel on a CUDA tensor, through
  :class:`_SnakeFunction` where a gradient is wanted (the backward kernel
  keeps only x and alpha), and :func:`snake_reference` on the CPU.
* :func:`check_constant_division` and :func:`check_channel_division` run
  the kernel's division functions on the card against the IEEE division
  (``__fdiv_rn``) and count the quotients that differ: the whole-domain
  proof that the kernel's multiply-and-correct sequences round as a true
  division (``chip_smoke.py`` phase 2).  They count no launch: no path
  calls them.

The plain version divides by 0-dim tensors of the input's device, not by
Python numbers: on the card eager PyTorch multiplies by a rounded
reciprocal when the divisor is a host scalar, which moves p2 / 6 by an ulp
in a third of its values; on the CPU both divide alike.  So the plain
version computes JAX's formula on either device, as the kernel does.
"""

from __future__ import annotations

import ctypes
import math
import struct

import torch

from . import _lib

_FORWARD = _lib.register(_lib.CudaKernel(
    "snake", "nawc_snake_forward",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
))
_BACKWARD = _lib.register(_lib.CudaKernel(
    "snake_backward", "nawc_snake_backward",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
))
_SCRATCH = _lib.CEntry(
    "snake_backward scratch", "nawc_snake_backward_scratch",
    [ctypes.c_int] * 4 + [ctypes.POINTER(ctypes.c_size_t)],
)
_CHECK_CONST = _lib.CEntry(
    "snake division check", "nawc_snake_check_const",
    [ctypes.c_int] + [ctypes.c_ulonglong] * 3 + [ctypes.c_void_p] * 2,
)
_CHECK_DEN = _lib.CEntry(
    "snake channel division check", "nawc_snake_check_den",
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int]
    + [ctypes.c_void_p] * 2,
)

_INV_PI = 1.0 / math.pi
_NULL = ctypes.c_void_p(None)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """The type the Snake computes in: float32, or float64 for a float64 input."""
    return t if t.dtype == torch.float64 else t.float()


def _div(t: torch.Tensor, d: float) -> torch.Tensor:
    """``t / d`` by a true division on any device (see the module's docstring)."""
    return t / torch.full((), d, dtype=t.dtype, device=t.device)


def sin2_periodic(z: torch.Tensor) -> torch.Tensor:
    """sin(z)^2 by range reduction and a 7th-order Taylor polynomial, as the
    JAX package computes it (its values, not ``torch.sin``'s: the
    polynomial's sin is off by at most 1.6e-4 and its square by at most
    3.1e-4, both at |u| = 0.5).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    zf = _wide(z)
    u = zf * _INV_PI
    u = u - torch.round(u)
    p = u * math.pi
    p2 = p * p
    s = p * (1.0 - _div(p2, 6.0) * (1.0 - _div(p2, 20.0) * (1.0 - _div(p2, 42.0))))
    return (s * s).to(z.dtype)


def _forward_plain(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """The forward with alpha (C,) given in x's rounding."""
    a = alpha.to(x.dtype)[None, :, None]
    # alpha * x stays float32 in a bfloat16 Snake: XLA drops the product's
    # rounding before the float32 range reduction, and the port follows
    s2 = sin2_periodic(_wide(a) * _wide(x)).to(x.dtype)
    return x + s2 / (a + 1e-9)


def snake_reference(x: torch.Tensor, log_alpha: torch.Tensor) -> torch.Tensor:
    """(B, C, T) activation, (C,) log alpha -> the Snake of x in x's type."""
    return _forward_plain(x, torch.exp(log_alpha).to(x.dtype))


def snake_backward_reference(
    x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """The backward kernel's formula: (B, C, T) x, (C,) alpha as the forward
    took it (in x's rounding), (B, C, T) output gradient g -> (dx in x's
    type, dalpha (C,) in the computing type).  The log-alpha gradient is
    ``alpha * dalpha``.

    S'(z) is the derivative of the polynomial chain as reverse-mode
    autodiff forms it (``round`` has zero gradient), each step rounded where
    the kernel rounds it; with gS = g / (alpha + 1e-9):
        dx     = g + gS S'(alpha x) alpha
        dalpha = sum_{b,t} gS S'(alpha x) x - sum_{b,t} g (S / (alpha+1e-9)) / (alpha+1e-9).
    In bfloat16, gS, gS S' alpha, dx, each term of the second sum and both
    sums round to bfloat16, where autograd of the plain bfloat16 forward
    rounds them; in float32 (and float64) nothing rounds but the steps."""
    def rnd(t):  # round to x's type, keep the computing type
        return t.to(x.dtype).to(t.dtype)

    xw, gw = _wide(x), _wide(g)
    a = _wide(alpha.to(x.dtype))[None, :, None]
    den = rnd(a + 1e-9)
    u = (a * xw) * _INV_PI
    u = u - torch.round(u)
    p = u * math.pi
    p2 = p * p
    t3 = 1.0 - _div(p2, 42.0)
    b20 = _div(p2, 20.0)
    t2 = 1.0 - b20 * t3
    a6 = _div(p2, 6.0)
    t1 = 1.0 - a6 * t2
    s = p * t1
    big_s = rnd(s * s)
    # reverse mode from dS = 1
    ds = s + s
    dp = ds * t1
    m1 = -(ds * p)
    da6 = m1 * t2
    m2 = -(m1 * a6)
    db20 = m2 * t3
    m3 = -(m2 * b20)
    dp2 = (_div(da6, 6.0) + _div(db20, 20.0)) + _div(m3, 42.0)
    dpp = dp2 * p
    dp = dp + (dpp + dpp)
    s_prime = (dp * math.pi) * _INV_PI
    dz = rnd(gw / den) * s_prime
    dx = (gw + rnd(dz * a)).to(x.dtype)
    by_x = rnd((dz * xw).sum(dim=(0, 2)))
    by_den = rnd(rnd(gw * rnd(rnd(big_s / den) / den)).sum(dim=(0, 2)))
    return dx, rnd(by_x - by_den)


def check_snake(name: str, x: torch.Tensor, *others: torch.Tensor) -> None:
    """Raise unless x and `others` are contiguous float32 or bfloat16 CUDA
    tensors of one type on one device (the other kernels take float32 only:
    ``_lib.check_cuda_f32``)."""
    for t in (x, *others):
        if t.dtype not in (torch.float32, torch.bfloat16) or t.dtype != x.dtype:
            raise ValueError(f"{name}: expected float32 or bfloat16 tensors of one type, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors")
        if not t.is_cuda or t.device != x.device:
            raise ValueError(f"{name}: all inputs must lie on one CUDA device, got {t.device}")


def _shape(name: str, x: torch.Tensor, alpha: torch.Tensor) -> tuple[int, int, int]:
    if x.dim() != 3 or alpha.shape != (x.shape[1],):
        raise ValueError(f"{name}: expected x (B, C, T) and alpha (C,), got {tuple(x.shape)}, "
                         f"{tuple(alpha.shape)}")
    if alpha.dtype != torch.float32 or not alpha.is_contiguous() or alpha.device != x.device:
        raise ValueError(f"{name}: expected a contiguous float32 alpha on {x.device}, got "
                         f"{alpha.dtype} on {alpha.device}")
    return tuple(int(s) for s in x.shape)


def _forward_cuda(x: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    check_snake("snake", x)
    b, c, t = _shape("snake", x, alpha)
    y = torch.empty_like(x)
    if y.numel():
        with torch.cuda.device(x.device):
            _FORWARD(_lib.ptr(x), _lib.ptr(alpha), _lib.ptr(y), b, c, t, x.element_size(),
                     _lib.stream(x))
    return y


def _backward_cuda(x: torch.Tensor, alpha: torch.Tensor, g: torch.Tensor, need_x: bool,
                   need_alpha: bool) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    check_snake("snake_backward", x, g)
    b, c, t = _shape("snake_backward", x, alpha)
    if g.shape != x.shape:
        raise ValueError(f"snake_backward: gradient {tuple(g.shape)} for x {tuple(x.shape)}")
    dx = torch.empty_like(x) if need_x else None
    # the reduction writes every channel; an empty x launches nothing
    alloc = torch.empty if x.numel() else torch.zeros
    dalpha = alloc(c, device=x.device, dtype=torch.float32) if need_alpha else None
    if x.numel() and (need_x or need_alpha):
        with torch.cuda.device(x.device):
            scratch = None
            if need_alpha:
                floats = ctypes.c_size_t()
                _SCRATCH(b, c, t, x.element_size(), ctypes.byref(floats))
                scratch = torch.empty(floats.value, device=x.device, dtype=torch.float32)
            _BACKWARD(_lib.ptr(x), _lib.ptr(g), _lib.ptr(alpha),
                      *(_lib.ptr(v) if v is not None else _NULL for v in (dx, dalpha, scratch)),
                      b, c, t, x.element_size(), _lib.stream(x))
    return dx, dalpha


class _SnakeFunction(torch.autograd.Function):
    """The Snake of x (B, C, T) with alpha (C,) in x's rounding, held in the
    computing type (float32; float64 for a float64 x).  On a CUDA tensor both
    passes are the kernel's; on the CPU the plain bodies stand in, so that
    the tests can drive this wiring.  It saves x and alpha only."""

    @staticmethod
    def forward(ctx, x, alpha):
        ctx.save_for_backward(x, alpha)
        return _forward_cuda(x, alpha) if _lib.use_kernel(x) else _forward_plain(x, alpha)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, alpha = ctx.saved_tensors
        need_x, need_alpha = ctx.needs_input_grad
        g = g.contiguous()
        if _lib.use_kernel(x):
            return _backward_cuda(x, alpha, g, need_x, need_alpha)
        dx, dalpha = snake_backward_reference(x, alpha, g)
        return (dx if need_x else None), (dalpha if need_alpha else None)


def snake(x: torch.Tensor, log_alpha: torch.Tensor) -> torch.Tensor:
    """The Snake of a contiguous (B, C, T) float32 or bfloat16 activation
    with per-channel ``alpha = exp(log_alpha)``: the kernel on a CUDA tensor
    (or the call raises), :func:`snake_reference` on the CPU.  On the card
    the gradient to x and log_alpha is the backward kernel's, computed only
    for the inputs that need it."""
    if not _lib.use_kernel(x):
        return snake_reference(x, log_alpha)
    alpha = _wide(torch.exp(log_alpha).to(x.dtype))
    if torch.is_grad_enabled() and (x.requires_grad or alpha.requires_grad):
        return _SnakeFunction.apply(x, alpha)
    return _forward_cuda(x, alpha)


def check_constant_division(d: int, device, first: int = 0, step: int = 1,
                            count: int = 2**32) -> dict[str, float]:
    """The kernel's division by the constant ``d`` (6, 20 or 42) on the card
    over the float32 bit patterns ``first + i * step`` (mod 2^32), i <
    count, against ``__fdiv_rn`` -> {"differ": patterns where the kernel's
    quotient differs (two NaNs agree), "fast": patterns that take the
    two-constant sequence, "fast_alone_differ": finite patterns where that
    sequence alone would differ, "fast_alone_max": the largest |v| among
    those, "patterns": count}."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"check_constant_division runs on the card, not on {dev}")
    out = torch.zeros(4, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        _CHECK_CONST(d, first, step, count, _lib.ptr(out), _lib.stream(out))
    n = out.cpu().tolist()
    top = struct.unpack("<f", struct.pack("<I", n[3]))[0]
    return dict(differ=n[0], fast=n[1], fast_alone_differ=n[2], fast_alone_max=top, patterns=count)


def check_channel_division(dens: torch.Tensor, nums: torch.Tensor | None = None,
                           bfloat16: bool = False) -> dict[str, int]:
    """The kernel's division by the per-channel ``a + 1e-9`` on the card:
    every value of ``dens`` (float32, on the card) against the numerators
    ``nums`` (float32, on the card) or, where None, against all 2^32 float32
    bit patterns, each pair against ``__fdiv_rn``, by the float32 kernels'
    sequence or, with ``bfloat16``, the bfloat16 kernels' (whose dens and
    numerators are bfloat16 values) -> {"differ": pairs whose quotients
    differ (two NaNs agree), "fast": pairs that take the Markstein
    sequence, "pairs": the pairs}."""
    _lib.check_cuda_f32("check_channel_division", dens, *(() if nums is None else (nums,)))
    out = torch.zeros(4, dtype=torch.int64, device=dens.device)
    with torch.cuda.device(dens.device):
        _CHECK_DEN(_lib.ptr(dens), dens.numel(), _NULL if nums is None else _lib.ptr(nums),
                   2**32 if nums is None else nums.numel(), 2 if bfloat16 else 4, _lib.ptr(out),
                   _lib.stream(out))
    n = out.cpu().tolist()
    return dict(differ=n[0], fast=n[1], pairs=n[2])


def bound_counts(n: int, c: int, esize: int, backward: bool) -> tuple[float, float]:
    """-> (bytes, float32 operations) one Snake pass needs over n elements
    of `esize` bytes in c channels: x read and y written (backward: x and g
    read, dx written, dalpha written) once each, alpha read once; 18
    operations an element forward (the product, the range reduction, the
    polynomial with its three divisions, the square, the division by
    alpha + 1e-9 and the sum), 44 backward (the forward's first 16, 18 for
    S', 10 for dx and the two terms of dalpha)."""
    if backward:
        return 3.0 * n * esize + 8.0 * c, 44.0 * n
    return 2.0 * n * esize + 4.0 * c, 18.0 * n
