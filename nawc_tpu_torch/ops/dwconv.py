"""The codec's depthwise (one group a channel) stride-1 bfloat16 convolutions
with SAME padding and the bias: the CUDA kernel ``csrc/dwconv.cu`` and its
plain PyTorch version.

* :func:`dwconv_reference` is the plain version: the arithmetic the codec's
  ``SameConv1d`` has for a depthwise conv on the CPU (``layers._conv``: a
  float32 grouped conv of the bfloat16 values at padding d (k - 1) / 2,
  rounded once, the bias added in bfloat16); in float32 and float64 the
  grouped conv with its bias in that type, as ``F.conv1d`` computes it.
* :func:`dwconv` runs the kernel on a CUDA tensor, through
  :class:`_DwConvFunction` where a gradient is wanted (its backward is
  PyTorch's convolution backward at the conv's own padding and groups), and
  :func:`dwconv_reference` on the CPU.
* :func:`takes` is the kernel's domain, which ``SameConv1d`` reads to choose
  the op: bfloat16, stride 1, groups equal to the input and output
  channels, k 7 at dilation 1, 3 or 9 (SNAC's geometries; any other
  depthwise conv keeps PyTorch's grouped conv).
"""

from __future__ import annotations

import contextlib
import ctypes

import torch
import torch.nn.functional as F

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "dwconv", "nawc_dwconv",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
))
_NULL = ctypes.c_void_p(None)
K, DILATIONS = 7, (1, 3, 9)  # the kernel's instantiations


def takes(x: torch.Tensor, c_in: int, c_out: int, k: int, stride: int, dilation: int,
          groups: int) -> bool:
    """Whether the kernel's op computes a conv of these settings on `x`
    (on the CPU the op is the plain version, with the same arithmetic)."""
    return (x.dtype == torch.bfloat16 and stride == 1 and groups == c_in == c_out
            and k == K and dilation in DILATIONS)


def dwconv_reference(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                     dilation: int) -> torch.Tensor:
    """(B, C, T) x, (C, 1, k) weight and (C,) bias or None (any float type;
    cast to x's) -> (B, C, T) in x's type.  On the card the float32 conv
    runs without TF32, as on the CPU."""
    c, k = weight.shape[0], weight.shape[-1]
    p = dilation * (k - 1) // 2
    w, b = weight.to(x.dtype), None if bias is None else bias.to(x.dtype)
    no_tf32 = torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)
    with no_tf32 if x.is_cuda else contextlib.nullcontext():
        if x.dtype == torch.bfloat16:
            y = F.conv1d(x.float(), w.float(), None, 1, p, dilation, c).to(x.dtype)
            return y if b is None else y + b[:, None]
        return F.conv1d(x, w, b, 1, p, dilation, c)


def _tables(weight: torch.Tensor, bias: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's taps (C, k) and bias (C,) (None without one), float32
    of bfloat16 values, kept until the parameters change."""
    def make():
        with torch.no_grad():
            w = weight.detach().to(torch.bfloat16).float().reshape(weight.shape[0], -1).contiguous()
            b = None if bias is None else bias.detach().to(torch.bfloat16).float().contiguous()
        return w, b

    return _lib.derived(weight, "dwconv", [t for t in (weight, bias) if t is not None], make)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, dilation: int) -> None:
    c, _, k = weight.shape
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        raise ValueError(f"dwconv: expected a bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"dwconv: weight on {weight.device}, bias on "
                         f"{None if bias is None else bias.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[1] != c or weight.shape[1] != 1 or (bias is not None and bias.shape != (c,)):
        raise ValueError(f"dwconv: x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}: not a depthwise conv")
    if not takes(x, c, c, k, 1, dilation, c):
        raise ValueError(f"dwconv: the kernel does not take k {k}, dilation {dilation}")


def _forward_cuda(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                  dilation: int) -> torch.Tensor:
    x = x.contiguous()
    _check(x, weight, bias, dilation)
    b, c, t = x.shape
    out = torch.empty_like(x)
    if out.numel():
        w_t, b_t = _tables(weight, bias)
        with torch.cuda.device(x.device):
            _KERNEL(_lib.ptr(x), _lib.ptr(w_t), _NULL if b_t is None else _lib.ptr(b_t), _lib.ptr(out),
                    b, c, t, weight.shape[-1], dilation, _lib.stream(x))
    return out


class _DwConvFunction(torch.autograd.Function):
    """The op with a gradient.  Forward: the kernel on a CUDA tensor, the
    plain version on the CPU (so that the tests can drive this wiring).
    Backward: PyTorch's convolution backward of the grouped conv at padding
    d (k - 1) / 2 with the weight in x's type, as autograd of the plain path
    computes it (the weight's and bias's gradients cast back to their own
    type)."""

    @staticmethod
    def forward(ctx, x, weight, bias, dilation):
        ctx.save_for_backward(x, weight)
        ctx.dilation = dilation
        ctx.bias_dtype = None if bias is None else bias.dtype
        if _lib.use_kernel(x):
            return _forward_cuda(x, weight, bias, dilation)
        return dwconv_reference(x, weight, bias, dilation)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dx = dw = db = None
        if need_x or need_w or need_b:
            c, k = weight.shape[0], weight.shape[-1]
            p = ctx.dilation * (k - 1) // 2
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.contiguous(), x, weight.to(x.dtype), [c], [1], [p], [ctx.dilation],
                False, [0], c, [need_x, need_w, need_b])
            dw = dw.to(weight.dtype) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, None


def dwconv(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           dilation: int) -> torch.Tensor:
    """The depthwise conv of a (B, C, T) bfloat16 activation with the (C, 1,
    k) weight and (C,) bias (or none) at SAME padding: the kernel on a CUDA
    tensor (or the call raises), with its taps laid out once per weight
    version; :func:`dwconv_reference` on the CPU.  A non-contiguous x is
    made contiguous."""
    if not _lib.use_kernel(x):
        return dwconv_reference(x, weight, bias, dilation)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias)):
        return _DwConvFunction.apply(x, weight, bias, dilation)
    return _forward_cuda(x, weight, bias, dilation)


def bound_bytes(b: int, c: int, t: int, k: int) -> float:
    """The bytes one call needs, which bound it (2 k FLOPs an output against
    4 bytes): x read and the output written once, the taps and bias read
    once, in bfloat16 (``counts_snac.dwconv_bytes``' yardstick)."""
    return 4.0 * b * c * t + 2.0 * c * (k + 1)
