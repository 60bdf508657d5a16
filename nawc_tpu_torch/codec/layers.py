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

SNAC's own blocks (``CodecConfig(layout="snac")``, after the ``snac``
package's ``layers.py`` and ``attention.py``) have no JAX counterpart:
depthwise-separable residual units (``groups`` = channels), strided and
transposed convs padded ceil(s / 2) on both sides (``snac=True``),
:class:`NoiseBlock` and :class:`LocalMHA`.  Weight norm folds into plain
weights at inference, so the modules hold plain weights.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops import dwconv as _dwconv
from ..ops import jaxrand as _jaxrand
from ..ops import same_conv as _same_conv
from ..ops.snake import sin2_periodic as _sin2_periodic  # noqa: F401  (kept under its old name)
from ..ops.snake import snake
from ..utils import jaxrand, profiling


def _conv(op, x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, *args) -> torch.Tensor:
    """``op(x, weight, bias, *args)`` in the dtype of `x`.  A bfloat16 conv
    on the CPU runs as a float32 conv of the bfloat16 values, rounded once,
    then the bias added in bfloat16, as XLA's CPU computes flax's conv: the
    oneDNN bfloat16 conv of PyTorch's CPU build returns wrong values at some
    strided shapes (stride 4, kernel 8)."""
    w, b = weight.to(x.dtype), None if bias is None else bias.to(x.dtype)
    if x.dtype == torch.bfloat16 and x.device.type == "cpu":
        y = op(x.float(), w.float(), None, *args).to(x.dtype)
        return y if b is None else y + b[:, None]
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
    residual itself; on the CPU the same arithmetic as below.

    ``snac=True`` pads a strided conv as SNAC's ``EncoderBlock`` does,
    ceil(s / 2) on both sides (flax's SAME pads 1 and 2 at stride 3, SNAC 2
    and 2; they agree at even strides).  A depthwise conv (``groups`` equal
    to the channels, SNAC's) is a span ``codec.dwconv`` of its own; in
    bfloat16, in the domain of ``ops.dwconv.takes`` (stride 1, k 7 at
    dilation 1, 3 or 9), it is the op ``ops.dwconv``: on the card the kernel
    ``csrc/dwconv.cu``, which pads and adds the bias itself; on the CPU the
    same arithmetic as below."""

    def __init__(self, *args, snac: bool = False, **kwargs):
        super().__init__(*args, **kwargs)
        self.snac = snac

    def pads(self, t: int) -> tuple[int, int]:
        """(left, right) zero padding of a length-`t` input."""
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        if self.snac and s > 1:
            return -(-s // 2), -(-s // 2)
        out = -(-t // s)
        total = max((out - 1) * s + d * (k - 1) + 1 - t, 0)
        return total // 2, total - total // 2

    def forward(self, x: torch.Tensor, residual: torch.Tensor | None = None) -> torch.Tensor:
        k, s, d = self.kernel_size[0], self.stride[0], self.dilation[0]
        if _same_conv.takes(x, self.in_channels, self.out_channels, k, s, d, self.groups):
            return _same_conv.same_conv(x, self.weight, self.bias, d, residual)
        if self.groups > 1 and self.groups == self.in_channels == self.out_channels and s == 1:
            with profiling.annotate("codec.dwconv", x.device):
                if _dwconv.takes(x, self.in_channels, self.out_channels, k, s, d, self.groups):
                    y = _dwconv.dwconv(x, self.weight, self.bias, d)
                else:
                    y = _conv(F.conv1d, x, self.weight, self.bias, 1, d * (k - 1) // 2, d, self.groups)
                return y if residual is None else residual + y
        left, right = self.pads(x.shape[-1])
        if left or right:
            x = F.pad(x, (left, right))
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

    def __init__(self, in_ch: int, out_ch: int, stride: int, snac: bool = False):
        k = 2 * stride
        if snac:
            # SNAC's DecoderBlock: padding ceil(s / 2), output_padding s % 2, which keeps
            # samples [2, 3T + 2) of the full output at stride 3 where flax's keeps [1, 3T + 1)
            super().__init__(in_ch, out_ch, k, stride=stride, padding=-(-stride // 2),
                             output_padding=stride % 2)
            self.trim = 0
            return
        left = -(-(k + stride - 2) // 2)
        super().__init__(in_ch, out_ch, k, stride=stride, padding=k - 1 - left)
        self.trim = stride % 2

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = _conv(F.conv_transpose1d, x, self.weight, self.bias, self.stride, self.padding,
                  self.output_padding)
        return y[..., : y.shape[-1] - self.trim] if self.trim else y


class ResidualUnit(nn.Module):
    """x + Conv_1(Snake_1(Conv_0(Snake_0(x)))); `Conv_0` depthwise where
    `depthwise` (SNAC's ``groups = dim``)."""

    def __init__(self, dim: int, dilation: int = 1, kernel: int = 7, depthwise: bool = False):
        super().__init__()
        self.Snake_0 = Snake(dim)
        self.Conv_0 = SameConv1d(dim, dim, kernel, dilation=dilation, groups=dim if depthwise else 1)
        self.Snake_1 = Snake(dim)
        self.Conv_1 = SameConv1d(dim, dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.Conv_1(self.Snake_1(self.Conv_0(self.Snake_0(x))), residual=x)


class EncoderBlock(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, stride: int, depthwise: bool = False,
                 snac: bool = False):
        super().__init__()
        self.ResidualUnit_0 = ResidualUnit(in_dim, 1, depthwise=depthwise)
        self.ResidualUnit_1 = ResidualUnit(in_dim, 3, depthwise=depthwise)
        self.ResidualUnit_2 = ResidualUnit(in_dim, 9, depthwise=depthwise)
        self.Snake_0 = Snake(in_dim)
        self.Conv_0 = SameConv1d(in_dim, out_dim, 2 * stride, stride=stride, snac=snac)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ResidualUnit_2(self.ResidualUnit_1(self.ResidualUnit_0(x)))
        return self.Conv_0(self.Snake_0(x))


class NoiseKey:
    """The keys of a codec's noise blocks: a host ``utils.jaxrand`` key,
    split on every draw, so that a run's noise follows from its seed."""

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        self.key = jaxrand.fold_in(jaxrand.prng_key(seed), 0x6E6F6973)  # "nois"

    def next(self) -> np.ndarray:
        self.key, sub = jaxrand.split(self.key)
        return sub


class NoiseDraw(nn.Module):
    """One draw of a noise block's normals, ``ops.jaxrand.normal(key, shape,
    device)`` (the kernel ``csrc/jaxrand.cu`` on the card) in float32: a
    module of its own, so that a forward hook sees each draw with its key."""

    def forward(self, key: np.ndarray, shape: tuple[int, ...], device) -> torch.Tensor:
        profiling.count("noise.normals", int(np.prod(shape)))
        return _jaxrand.normal(key, shape, device)


class NoiseBlock(nn.Module):
    """SNAC's ``NoiseBlock``: x + n * Conv_0(x), with `Conv_0` a k1 conv
    without bias and n (B, 1, T) standard normals drawn anew on every call
    (``jaxrand`` keys from `keys` in place of ``torch.randn``), rounded to
    x's dtype; the product and sum round once (``addcmul``)."""

    def __init__(self, dim: int, keys: NoiseKey):
        super().__init__()
        self.Conv_0 = SameConv1d(dim, dim, 1, bias=False)
        self.draw = NoiseDraw()
        self.keys = keys

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("codec.noise", x.device):
            b, _, t = x.shape
            n = self.draw(self.keys.next(), (b, 1, t), x.device)
            return torch.addcmul(x, n.to(x.dtype), self.Conv_0(x))


def rotary_tables(positions: torch.Tensor, dim_head: int) -> tuple[torch.Tensor, torch.Tensor]:
    """SNAC's rotary embedding (``SinusoidalEmbeddings``, no xpos): cos and
    sin of positions x 10000^(-2i / dim_head), the half-width repeated, in
    float32 -> two tensors of ``positions.shape + (dim_head,)``."""
    inv_freq = 10000.0 ** (-torch.arange(0, dim_head, 2, device=positions.device,
                                         dtype=torch.float32) / dim_head)
    freqs = positions.float()[..., None] * inv_freq
    freqs = torch.cat((freqs, freqs), dim=-1)
    return freqs.cos(), freqs.sin()


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


class LocalMHA(nn.Module):
    """SNAC's ``LocalMHA``: LayerNorm over channels, q, k, v by one
    projection without bias, heads of 64, non-overlapping windows of
    `window` frames with rotary positions 0 .. window - 1 in each, softmax
    attention inside each window (scale 1/8), an output projection without
    bias, the residual added.  (B, C, T) -> (B, C, T), T a multiple of the
    window.  In bfloat16 the LayerNorm's statistics, the rotary products
    and the softmax run in float32 (``F.scaled_dot_product_attention``
    over (B * windows, heads, window, 64)); every tensor between them is
    rounded to bfloat16."""

    dim_head = 64

    def __init__(self, dim: int, window: int):
        super().__init__()
        if dim % self.dim_head:
            raise ValueError(f"LocalMHA: {dim} channels are not heads of {self.dim_head}")
        self.heads = dim // self.dim_head
        self.window = window
        self.norm = nn.LayerNorm(dim)
        self.to_qkv = nn.Linear(dim, 3 * dim, bias=False)
        self.to_out = nn.Linear(dim, dim, bias=False)

    def positions(self, t: int, device) -> torch.Tensor:
        """(windows, window) positions of the frames within their windows."""
        return torch.arange(self.window, device=device).expand(t // self.window, self.window)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with profiling.annotate("codec.attention", x.device):
            b, c, t = x.shape
            w, h, dh = self.window, self.heads, self.dim_head
            if t % w:
                raise ValueError(f"LocalMHA: {t} frames are not windows of {w}")
            dt = x.dtype
            y = F.layer_norm(x.transpose(1, 2), (c,), self.norm.weight.to(dt), self.norm.bias.to(dt),
                             self.norm.eps)
            qkv = F.linear(y, self.to_qkv.weight.to(dt))  # (B, T, 3C)
            # (3, B, windows, heads, window, 64)
            q, k, v = qkv.view(b, t // w, w, 3, h, dh).permute(3, 0, 1, 4, 2, 5)
            cos, sin = rotary_tables(self.positions(t, x.device), dh)
            cos, sin = cos[None, :, None], sin[None, :, None]
            q = (q.float() * cos + rotate_half(q).float() * sin).to(dt)
            k = (k.float() * cos + rotate_half(k).float() * sin).to(dt)
            o = F.scaled_dot_product_attention(q.reshape(-1, h, w, dh), k.reshape(-1, h, w, dh),
                                               v.reshape(-1, h, w, dh))
            o = o.view(b, t // w, h, w, dh).permute(0, 1, 3, 2, 4).reshape(b, t, c)
            return x + F.linear(o, self.to_out.weight.to(dt)).transpose(1, 2)


class DecoderBlock(nn.Module):
    """Decoder upsampling block.  The JAX block's ``NoiseBlock`` is off on
    every path of the JAX codec (``use_noise=False``, in float32 and bfloat16
    alike); here it runs where `noise` holds the codec's keys (SNAC's)."""

    def __init__(self, in_dim: int, out_dim: int, stride: int, depthwise: bool = False,
                 snac: bool = False, noise: NoiseKey | None = None):
        super().__init__()
        self.Snake_0 = Snake(in_dim)
        self.ConvTranspose_0 = SameConvTranspose1d(in_dim, out_dim, stride, snac=snac)
        if noise is not None:
            self.NoiseBlock_0 = NoiseBlock(out_dim, noise)
        self.ResidualUnit_0 = ResidualUnit(out_dim, 1, depthwise=depthwise)
        self.ResidualUnit_1 = ResidualUnit(out_dim, 3, depthwise=depthwise)
        self.ResidualUnit_2 = ResidualUnit(out_dim, 9, depthwise=depthwise)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.ConvTranspose_0(self.Snake_0(x))
        if hasattr(self, "NoiseBlock_0"):
            x = self.NoiseBlock_0(x)
        return self.ResidualUnit_2(self.ResidualUnit_1(self.ResidualUnit_0(x)))
