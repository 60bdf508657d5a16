"""The codec's stride-1 bfloat16 convolutions with SAME padding, the bias and
an optional residual add: the CUDA kernel ``csrc/same_conv.cu`` and its
plain PyTorch version.

* :func:`same_conv_reference` is the plain version: the arithmetic the codec's
  ``SameConv1d`` and ``ResidualUnit`` have on the CPU (pad, a float32 conv of
  the bfloat16 values rounded once, the bias added in bfloat16, then the
  residual's ``x + y``); in float32 and float64 the conv with its bias in
  that type, as ``F.conv1d`` computes it.
* :func:`same_conv` runs the kernel on a CUDA tensor, through
  :class:`_SameConvFunction` where a gradient is wanted (its backward is
  PyTorch's convolution backward at the conv's own symmetric padding), and
  :func:`same_conv_reference` on the CPU.
* :func:`takes` is the kernel's domain, which ``SameConv1d`` reads to choose
  the op: bfloat16, stride 1, one group, odd k <= 7, padding d (k - 1) / 2 <=
  32, C_in and C_out multiples of 16.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "same_conv", "nawc_same_conv",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
))
_NULL = ctypes.c_void_p(None)
MAX_K, MAX_PAD = 7, 32  # the kernel's shared-memory tile holds these taps and halo


def takes(x: torch.Tensor, c_in: int, c_out: int, k: int, stride: int, dilation: int,
          groups: int) -> bool:
    """Whether the kernel's op computes a conv of these settings on `x`
    (on the CPU the op is the plain version, with the same arithmetic)."""
    return (x.dtype == torch.bfloat16 and stride == 1 and groups == 1 and k % 2 == 1
            and k <= MAX_K and dilation * (k - 1) // 2 <= MAX_PAD and c_in % 16 == 0
            and c_out % 16 == 0)


def same_conv_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                        dilation: int, residual: torch.Tensor | None = None) -> torch.Tensor:
    """(B, C_in, T) x, (C_out, C_in, k) weight and (C_out,) bias or None
    (any float type; cast to x's) -> (B, C_out, T) in x's type, plus
    `residual`.  On the card the float32 conv runs without TF32, as on the
    CPU."""
    k = weight.shape[-1]
    p = dilation * (k - 1) // 2
    xp = F.pad(x, (p, p)) if p else x
    w, b = weight.to(x.dtype), None if bias is None else bias.to(x.dtype)
    no_tf32 = torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)
    with no_tf32 if x.is_cuda else contextlib.nullcontext():
        if x.dtype == torch.bfloat16:
            y = F.conv1d(xp.float(), w.float(), None, 1, 0, dilation).to(x.dtype)
            y = y if b is None else y + b[:, None]
        else:
            y = F.conv1d(xp, w, b, 1, 0, dilation)
    return y if residual is None else residual + y


def _tables(weight: torch.Tensor, bias: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weights (k, C_out, C_in) bfloat16 and bias (C_out,)
    float32 of bfloat16 values (zero for a conv without bias, which adds
    nothing), kept until the parameters change."""
    def make():
        with torch.no_grad():
            w = weight.detach().to(torch.bfloat16).permute(2, 0, 1).contiguous()
            b = (torch.zeros(weight.shape[0], device=weight.device) if bias is None
                 else bias.detach().to(torch.bfloat16).float().contiguous())
        return w, b

    return _lib.derived(weight, "same_conv", [t for t in (weight, bias) if t is not None], make)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None,
           dilation: int) -> None:
    c_out, c_in, k = weight.shape
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        raise ValueError(f"same_conv: expected a bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"same_conv: weight on {weight.device}, bias on "
                         f"{None if bias is None else bias.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[1] != c_in:
        raise ValueError(f"same_conv: x {tuple(x.shape)} for a weight of {c_in} input channels")
    if not takes(x, c_in, c_out, k, 1, dilation, 1):
        raise ValueError(f"same_conv: the kernel does not take C_in {c_in}, C_out {c_out}, k {k}, "
                         f"dilation {dilation}")
    if residual is not None and (residual.shape != (x.shape[0], c_out, x.shape[2])
                                 or residual.dtype != x.dtype or residual.device != x.device):
        raise ValueError(f"same_conv: residual {tuple(residual.shape)} {residual.dtype} for an output "
                         f"of {(x.shape[0], c_out, x.shape[2])}")


def _forward_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                  residual: torch.Tensor | None, dilation: int) -> torch.Tensor:
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    _check(x, weight, bias, residual, dilation)
    c_out, c_in, k = weight.shape
    b, _, t = x.shape
    out = torch.empty((b, c_out, t), dtype=x.dtype, device=x.device)
    if out.numel():
        w_p, b_f = _tables(weight, bias)
        with torch.cuda.device(x.device):
            _KERNEL(_lib.ptr(x), _lib.ptr(w_p), _lib.ptr(b_f),
                    _NULL if residual is None else _lib.ptr(residual), _lib.ptr(out),
                    b, c_in, c_out, t, k, dilation, _lib.stream(x))
    return out


class _SameConvFunction(torch.autograd.Function):
    """The op with a gradient.  Forward: the kernel on a CUDA tensor, the
    plain version on the CPU (so that the tests can drive this wiring).
    Backward: PyTorch's convolution backward of the conv at padding
    d (k - 1) / 2 with the weight in x's type, as autograd of the plain
    path computes it (the weight's and bias's gradients cast back to their
    own type); the residual's gradient is the output's."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, dilation):
        ctx.save_for_backward(x, weight)
        ctx.dilation = dilation
        ctx.bias_dtype = None if bias is None else bias.dtype
        if _lib.use_kernel(x):
            return _forward_cuda(x, weight, bias, residual, dilation)
        return same_conv_reference(x, weight, bias, dilation, residual)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b, need_res = ctx.needs_input_grad[:4]
        dx = dw = db = None
        if need_x or need_w or need_b:
            k = weight.shape[-1]
            p = ctx.dilation * (k - 1) // 2
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.contiguous(), x, weight.to(x.dtype), [weight.shape[0]], [1], [p], [ctx.dilation],
                False, [0], 1, [need_x, need_w, need_b])
            dw = dw.to(weight.dtype) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, (g if need_res else None), None


def same_conv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, dilation: int,
              residual: torch.Tensor | None = None) -> torch.Tensor:
    """The conv of a (B, C_in, T) bfloat16 activation with the (C_out, C_in,
    k) weight and (C_out,) bias (or none) at SAME padding, plus `residual` (B, C_out,
    T) if given: the kernel on a CUDA tensor (or the call raises), with its
    weights laid out once per weight version; :func:`same_conv_reference` on
    the CPU.  A non-contiguous x or residual is made contiguous."""
    if not _lib.use_kernel(x):
        return same_conv_reference(x, weight, bias, dilation, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, weight, bias, residual)):
        return _SameConvFunction.apply(x, weight, bias, residual, dilation)
    return _forward_cuda(x, weight, bias, residual, dilation)


def bound_counts(b: int, c_in: int, c_out: int, t: int, k: int, residual: bool) -> tuple[float, float]:
    """-> (bytes, FLOPs) one call needs: x read and the output written once
    (and the residual read), the weights and bias read once; 2 C_in k FLOPs
    an output."""
    nbytes = 2.0 * b * t * (c_in + c_out * (2 if residual else 1)) + 2.0 * k * c_in * c_out + 4.0 * c_out
    return nbytes, 2.0 * b * t * c_out * c_in * k
