"""Convolutional building blocks of the SNAC-style codec
(``nawc_tpu/codec/layers.py``), in PyTorch's (B, C, T) layout.

Submodules are named as flax names them (``Conv_0``, ``Snake_1``,
``ResidualUnit_2``, ``ConvTranspose_0``), so that ``convert.py`` maps a flax
checkpoint onto these modules by walking its paths.  Convolutions reproduce
flax's "SAME" padding: for output length ceil(T / stride) the total padding
is split with the smaller half on the left.

Every block computes in the dtype of its input, as flax's ``dtype=`` does:
the convolutions cast their float32 weights to it, so a bfloat16 input runs
the whole block in bfloat16.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import same_conv as _same_conv
from ..ops.snake import sin2_periodic as _sin2_periodic  # noqa: F401  (kept under its old name)
from ..ops.snake import snake


def _conv(op, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, *args) -> torch.Tensor:
    """``op(x, weight, bias, *args)`` in the dtype of `x`.  A bfloat16 conv
    on the CPU runs as a float32 conv of the bfloat16 values, rounded once,
    then the bias added in bfloat16, as XLA's CPU computes flax's conv: the
    oneDNN bfloat16 conv of PyTorch's CPU build returns wrong values at some
    strided shapes (stride 4, kernel 8)."""
    w, b = weight.to(x.dtype), bias.to(x.dtype)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        return op(x.float(), w.float(), None, *args).to(x.dtype) + b[:, None]
    return op(x, w, b, *args)


class Snake(nn.Module):
    """Snake activation: x + sin^2(alpha x)/alpha with per-channel alpha
    (``ops.snake``: the kernel ``csrc/snake.cu`` on the card, forward and
    backward; the plain version on the CPU)."""

    def __init__(self, channels: int):
        super().__init__()
        self.log_alpha = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return snake(x.contiguous(), self.log_alpha)


class SameConv1d(nn.Conv1d):
    """``nn.Conv1d`` with flax's "SAME" padding (any stride, dilation or
    group count), plus `residual` where given.  A bfloat16 conv in the
    domain of ``ops.same_conv.takes`` (stride 1, one group, odd k <= 7,
    padding <= 32, channel counts multiples of 16) is the op
    ``ops.same_conv``: on the card the
    kernel ``csrc/same_conv.cu``, which pads, adds the bias and the
    residual itself; on the CPU the same arithmetic as below."""

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        if _same_conv.takes(x, self.in_channels, self.out_channels, k, s, d, self.groups):
            return _same_conv.same_conv(x, self.weight, self.bias, d, residual)
        t = x.shape[-1]
        out = -(-t // s)
        total = max((out - 1) * s + d * (k - 1) + 1 - t, 0)
        if total:
            x = F.pad(x, (total // 2, total - total // 2))
        y = _conv(F.conv1d, x, self.weight, self.bias, s, 0, d, self.groups)
        return y if residual is None else residual + y


class SameConvTranspose1d(nn.ConvTranspose1d):
    """flax ``ConvTranspose`` with "SAME" padding and kernel 2*stride: the
    output is stride times longer.  ``convert.py`` flips the flax kernel
    along time for this module.

    ``jax.lax``'s SAME transpose pads the stride-dilated input by
    (ceil((k + s - 2) / 2), floor((k + s - 2) / 2)).  For an even stride the
    two are equal, which ``padding = s / 2`` gives.  For an odd stride the
    left one is larger by one: the module pads both sides by the left
    amount (``padding = k - 1 - left``) and drops the extra last sample."""

    def __init__(self, in_ch: int, out_ch: int, stride: int):
        k = 2 * stride
        left = -(-(k + stride - 2) // 2)
        super().__init__(in_ch, out_ch, k, stride=stride, padding=k - 1 - left)
        self.trim = stride % 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(F.conv_transpose1d, x, self.weight, self.bias, self.stride, self.padding)
        return y[..., : y.shape[-1] - self.trim] if self.trim else y


class ResidualUnit(nn.Module):
    def __init__(self, dim: int, dilation: int = 1, kernel: int = 7):
        super().__init__()
        self.Snake_0 = Snake(dim)
        self.Conv_0 = SameConv1d(dim, dim, kernel, dilation=dilation)
        self.Snake_1 = Snake(dim)
        self.Conv_1 = SameConv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(self.Snake_1(self.Conv_0(self.Snake_0(x))), residual=x)


class EncoderBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int):
        super().__init__()
        self.ResidualUnit_0 = ResidualUnit(in_dim, 1)
        self.ResidualUnit_1 = ResidualUnit(in_dim, 3)
        self.ResidualUnit_2 = ResidualUnit(in_dim, 9)
        self.Snake_0 = Snake(in_dim)
        self.Conv_0 = SameConv1d(in_dim, out_dim, 2 * stride, stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ResidualUnit_2(self.ResidualUnit_1(self.ResidualUnit_0(x)))
        return self.Conv_0(self.Snake_0(x))


class DecoderBlock(nn.Module):
    """Decoder upsampling block.  The JAX block's ``NoiseBlock`` is off on
    every path of the codec (``use_noise=False``, in float32 and bfloat16
    alike), so it is not ported: with no noise it is the identity."""

    def __init__(self, in_dim: int, out_dim: int, stride: int):
        super().__init__()
        self.Snake_0 = Snake(in_dim)
        self.ConvTranspose_0 = SameConvTranspose1d(in_dim, out_dim, stride)
        self.ResidualUnit_0 = ResidualUnit(out_dim, 1)
        self.ResidualUnit_1 = ResidualUnit(out_dim, 3)
        self.ResidualUnit_2 = ResidualUnit(out_dim, 9)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(self.Snake_0(x))
        return self.ResidualUnit_2(self.ResidualUnit_1(self.ResidualUnit_0(x)))
