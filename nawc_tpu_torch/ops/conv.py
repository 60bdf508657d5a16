"""Every convolution of the codec behind one op: the plain arithmetic, which
hand-written kernel takes a conv, and how a kernel's conv gets its gradient.
:func:`conv1d` takes the route by where x lies and whether a kernel takes
the conv (``same_conv.takes``, ``dwconv.takes``):

=========  ===============================================  ==================
x on       a kernel takes it                                no kernel takes it
=========  ===============================================  ==================
the CPU    :func:`conv_plain`                               :func:`conv_plain`
the card   the kernel; :func:`conv_plain` under             cuDNN in x's type
           ``plain_versions()``                             (:func:`conv_native`)
=========  ===============================================  ==================

Where a gradient is wanted, a kernel's conv runs through :class:`_KernelConv`.
Transposed convs take :func:`conv_native`.  A kernel takes a conv at its
padding, SAME's or a causal one (all zeros on the left, Mimi's), as a
binding's ``takes`` admits it.
"""

from __future__ import annotations

import contextlib
from collections.abc import Callable

import torch
import torch.nn.functional as F

from . import _lib, dwconv, same_conv

_BINDINGS = (same_conv, dwconv)  # each kernel's binding: its domain (takes) and its launch


def conv_plain(op, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *args) -> torch.Tensor:
    """``op(x, weight, bias, *args)`` (``F.conv1d`` or ``F.conv_transpose1d``)
    in the dtype of `x`, with the weight and bias cast to it.  A bfloat16
    conv runs as a float32 conv of the bfloat16 values, rounded once, then
    the bias added in bfloat16, as XLA's CPU computes flax's conv: the
    oneDNN bfloat16 conv of PyTorch's CPU build returns wrong values at some
    strided shapes (stride 4, kernel 8).  On the card the float32 conv runs
    without TF32, as on the CPU."""
    w, b = weight.to(x.dtype), None if bias is None else bias.to(x.dtype)
    no_tf32 = torch.backends.cudnn.flags(
        enabled=torch.backends.cudnn.enabled, benchmark=torch.backends.cudnn.benchmark,
        deterministic=torch.backends.cudnn.deterministic, allow_tf32=False)
    with no_tf32 if x.is_cuda else contextlib.nullcontext():
        if x.dtype == torch.bfloat16:
            y = op(x.float(), w.float(), None, *args).to(x.dtype)
            return y if b is None else y + b[:, None]
        return op(x, w, b, *args)


def conv_native(op, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *args) -> torch.Tensor:
    """``op(x, weight, bias, *args)`` in the dtype of `x`: PyTorch's own conv
    (cuDNN) on the card, :func:`conv_plain` on the CPU."""
    if not x.is_cuda:
        return conv_plain(op, x, weight, bias, *args)
    return op(x, weight.to(x.dtype), None if bias is None else bias.to(x.dtype), *args)


def _padded(conv, x, weight, bias, stride, padding, dilation, groups, residual):
    """`conv` of ``F.conv1d`` at `padding` (see :func:`conv1d`), plus `residual`."""
    if callable(padding):
        left, right = padding(x.shape[-1])
        if left or right:
            x = F.pad(x, (left, right))
        padding = 0
    y = conv(F.conv1d, x, weight, bias, stride, padding, dilation, groups)
    return y if residual is None else residual + y


def _pads(padding: int | Callable[[int], tuple[int, int]], t: int) -> tuple[int, int]:
    """(left, right) zeros of a conv's `padding` (see :func:`conv1d`) at T = `t`."""
    return padding(t) if callable(padding) else (padding, padding)


class _KernelConv(torch.autograd.Function):
    """A kernel's conv with a gradient.  Forward: the kernel's launch on the
    card, the plain version on the CPU (so that the tests can drive this
    wiring).  Backward: PyTorch's convolution backward of the conv at its
    padding (left, right), dilation and groups, with the weight in x's type,
    as autograd of the plain version computes it (the weight's and bias's
    gradients cast back to their own types; at an uneven padding the
    backward of the conv of the padded x, its gradient cut to x); the
    residual's gradient is the output's."""

    @staticmethod
    def forward(ctx, x, weight, bias, residual, kernel, padding, dilation, groups):
        ctx.save_for_backward(x, weight)
        ctx.dilation, ctx.groups = dilation, groups
        ctx.pads = _pads(padding, x.shape[-1])
        ctx.bias_dtype = None if bias is None else bias.dtype
        if _lib.use_kernel(x):
            return kernel.launch(x, weight, bias, residual, dilation, ctx.pads[0])
        return _padded(conv_plain, x, weight, bias, 1, padding, dilation, groups, residual)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        x, weight = ctx.saved_tensors
        need_x, need_w, need_b, need_res = ctx.needs_input_grad[:4]
        dx = dw = db = None
        if need_x or need_w or need_b:
            left, right = ctx.pads
            xp, p = (x, left) if left == right else (F.pad(x, (left, right)), 0)
            dx, dw, db = torch.ops.aten.convolution_backward(
                g.contiguous(), xp, weight.to(x.dtype), [weight.shape[0]], [1], [p], [ctx.dilation],
                False, [0], ctx.groups, [need_x, need_w, need_b])
            dx = dx[..., left: left + x.shape[-1]] if need_x and xp is not x else dx
            dw = dw.to(weight.dtype) if need_w else None
            db = db.to(ctx.bias_dtype) if need_b else None
        return dx, dw, db, (g if need_res else None), None, None, None, None


def conv1d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int,
           padding: int | Callable[[int], tuple[int, int]], dilation: int, groups: int,
           residual: torch.Tensor | None = None) -> torch.Tensor:
    """``F.conv1d`` of a (B, C_in, T) activation with the (C_out, C_in /
    groups, k) weight and (C_out,) bias (or none), in x's type, plus
    `residual` (B, C_out, T') where given, by the route of the module's
    table.  `padding` is an int, padded on both sides inside the conv, or a
    function of T that gives the (left, right) zeros padded before it
    (``F.pad``); a kernel pads the same zeros itself (a binding's ``takes``
    admits the conv at that padding)."""
    c_out, c_in_group, k = weight.shape
    pads = _pads(padding, x.shape[-1])
    for kernel in _BINDINGS:
        if kernel.takes(x, c_in_group * groups, c_out, k, stride, dilation, groups, pads):
            break
    else:
        return _padded(conv_native, x, weight, bias, stride, padding, dilation, groups, residual)
    if not _lib.use_kernel(x):
        return _padded(conv_plain, x, weight, bias, 1, padding, dilation, groups, residual)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, weight, bias, residual)):
        return _KernelConv.apply(x, weight, bias, residual, kernel, padding, dilation, groups)
    return kernel.launch(x, weight, bias, residual, dilation, pads[0])
