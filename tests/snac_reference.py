"""SNAC (hubertsiuzdak/snac, ``snac/snac.py``, ``layers.py``, ``attention.py``,
``vq.py``) from its equations, in plain float32 PyTorch with TF32 off: the
reference that ``tests/test_torch_snac.py`` holds the port's SNAC layout to.
It imports nothing of the port or of JAX.

Layers (C channels, (B, C, T) tensors; weights keyed by the port's parameter
names):

* ResidualUnit(C, d): x + Conv_k1(Snake(Conv_k7,d(Snake(x)))), the k7 conv
  depthwise (groups = C) where the configuration says so, padded 3 d on
  each side;
* EncoderBlock(C -> 2C, s): three residual units (d = 1, 3, 9), Snake, a
  conv of kernel 2 s, stride s, padding ceil(s / 2);
* Encoder: conv 1 -> C0 (k7), the blocks, LocalMHA (where `attn_window`
  is not 0), a k7 conv (depthwise);
* Decoder: a depthwise k7 conv and a k1 conv to the decoder's width (one k7
  conv where not depthwise), LocalMHA, the blocks, Snake, conv to one
  channel (k7), tanh;
* DecoderBlock(C -> C / 2, s): Snake, a transposed conv (kernel 2 s, stride
  s, padding ceil(s / 2), output_padding s mod 2), NoiseBlock, three
  residual units;
* NoiseBlock(C): x + n Conv_k1,nobias(x), n (B, 1, T) standard normals;
* LocalMHA(D): LayerNorm over channels, q, k, v = x W_qkv (no bias), heads
  of 64, non-overlapping windows of `attn_window` frames, rotary positions
  0 .. window - 1 in each window (inv_freq 10000^(-2i / 64), halves
  rotated, no xpos), softmax(q k^T / 8) v inside each window, W_out (no
  bias), plus the residual;
* each VQ level: average-pool by its stride, in_proj, the code of highest
  cosine, out_proj, repeat stride times, subtract from the residual.

Departures from the published model, none of which changes a shape:

* weight norm is folded: every conv holds its plain weight;
* the noise is an argument (the draws the port made from its keyed
  ``jaxrand`` normals), not ``torch.randn``;
* Snake's sin^2 is the codec's polynomial (u = a x / pi reduced to
  [-1/2, 1/2], sin(pi u) to p^7, squared), which the port's Snake
  computes; ``torch.sin`` differs from it by up to 3e-4 in sin^2;
* Snake's alpha is exp(log_alpha), the port's parameter.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

DIM_HEAD = 64


def sin2(z: torch.Tensor) -> torch.Tensor:
    u = z * (1.0 / math.pi)
    u = u - torch.round(u)
    p = u * math.pi
    p2 = p * p
    s = p * (1.0 - p2 / 6.0 * (1.0 - p2 / 20.0 * (1.0 - p2 / 42.0)))
    return s * s


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def chunk(cfg: dict) -> int:
    """SNAC's ``preprocess``: pad to hop * lcm(vq_strides[0], attn_window)."""
    return math.prod(cfg["encoder_rates"]) * math.lcm(cfg["vq_strides"][0], cfg["attn_window"] or 1)


class Snac:
    """SNAC of `cfg` (``encoder_dim``, ``encoder_rates``, ``decoder_dim``,
    ``decoder_rates``, ``vq_strides``, ``attn_window``, ``depthwise``) on
    the weights `w` (name -> float32 tensor)."""

    def __init__(self, w: dict, cfg: dict):
        self.w, self.cfg = {k: v.float() for k, v in w.items()}, cfg
        torch.backends.cudnn.allow_tf32 = False  # true float32 convs and products on a card
        torch.backends.cuda.matmul.allow_tf32 = False

    # -- layers ----------------------------------------------------------
    def conv(self, name, x, stride=1, dilation=1, groups=1, padding=None):
        w, b = self.w[f"{name}.weight"], self.w.get(f"{name}.bias")
        if padding is None:
            padding = dilation * (w.shape[-1] - 1) // 2
        return F.conv1d(x, w, b, stride, padding, dilation, groups)

    def snake(self, name, x):
        a = torch.exp(self.w[f"{name}.log_alpha"])[None, :, None]
        return x + sin2(a * x) / (a + 1e-9)

    def residual_unit(self, name, x, dilation):
        groups = x.shape[1] if self.cfg["depthwise"] else 1
        y = self.conv(f"{name}.Conv_0", self.snake(f"{name}.Snake_0", x), dilation=dilation,
                      groups=groups)
        return x + self.conv(f"{name}.Conv_1", self.snake(f"{name}.Snake_1", y))

    def attention(self, name, x):
        b, c, t = x.shape
        win, heads = self.cfg["attn_window"], c // DIM_HEAD
        y = F.layer_norm(x.transpose(1, 2), (c,), self.w[f"{name}.norm.weight"],
                         self.w[f"{name}.norm.bias"], 1e-5)
        q, k, v = (y @ self.w[f"{name}.to_qkv.weight"].T).chunk(3, dim=-1)
        # b (w n) (h d) -> b h w n d
        q, k, v = (u.reshape(b, t // win, win, heads, DIM_HEAD).permute(0, 3, 1, 2, 4)
                   for u in (q, k, v))
        inv_freq = 1.0 / 10000 ** (torch.arange(0, DIM_HEAD, 2).float() / DIM_HEAD)
        freqs = torch.arange(win).float()[:, None] * inv_freq
        freqs = torch.cat((freqs, freqs), dim=-1)
        q = q * freqs.cos() + rotate_half(q) * freqs.sin()
        k = k * freqs.cos() + rotate_half(k) * freqs.sin()
        att = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(DIM_HEAD), dim=-1)
        o = (att @ v).permute(0, 2, 3, 1, 4).reshape(b, t, c)
        return x + (o @ self.w[f"{name}.to_out.weight"].T).transpose(1, 2)

    def noise_block(self, name, x, n):
        return x + n * self.conv(f"{name}.Conv_0", x)

    # -- encoder / decoder -----------------------------------------------
    def encode_latent(self, wav):
        """(B, T) -> (B, T / hop, latent) latents."""
        dw = self.cfg["depthwise"]
        h = self.conv("encoder.Conv_0", wav[:, None, :])
        for i, s in enumerate(self.cfg["encoder_rates"]):
            blk = f"encoder.EncoderBlock_{i}"
            for j, d in enumerate((1, 3, 9)):
                h = self.residual_unit(f"{blk}.ResidualUnit_{j}", h, d)
            h = self.conv(f"{blk}.Conv_0", self.snake(f"{blk}.Snake_0", h), stride=s,
                          padding=math.ceil(s / 2))
        if self.cfg["attn_window"]:
            h = self.attention("encoder.LocalMHA_0", h)
        h = self.conv("encoder.DWConv_0", h, groups=h.shape[1] if dw else 1)
        return h.transpose(1, 2)

    def decode_latent(self, z, noise):
        """(B, T', latent) and one (B, 1, T) noise a block -> (B, T) audio."""
        h = z.transpose(1, 2)
        if self.cfg["depthwise"]:
            h = self.conv("decoder.DWConv_0", h, groups=h.shape[1])
        h = self.conv("decoder.Conv_0", h)
        if self.cfg["attn_window"]:
            h = self.attention("decoder.LocalMHA_0", h)
        for i, s in enumerate(self.cfg["decoder_rates"]):
            blk = f"decoder.DecoderBlock_{i}"
            h = self.snake(f"{blk}.Snake_0", h)
            w, b = self.w[f"{blk}.ConvTranspose_0.weight"], self.w[f"{blk}.ConvTranspose_0.bias"]
            h = F.conv_transpose1d(h, w, b, s, math.ceil(s / 2), s % 2)
            h = self.noise_block(f"{blk}.NoiseBlock_0", h, noise[i])
            for j, d in enumerate((1, 3, 9)):
                h = self.residual_unit(f"{blk}.ResidualUnit_{j}", h, d)
        h = self.snake("decoder.Snake_0", h)
        return torch.tanh(self.conv("decoder.Conv_1", h))[:, 0]

    # -- residual VQ -----------------------------------------------------
    def quantize(self, z, forced=None):
        """z (B, T', D) -> (z_q, codes); with `forced` the levels follow
        those codes."""
        residual, zq, codes = z, torch.zeros_like(z), []
        for i, s in enumerate(self.cfg["vq_strides"]):
            lvl = f"quantizer.level_{i}"
            pooled = F.avg_pool1d(residual.transpose(1, 2), s, s).transpose(1, 2)
            z_e = pooled @ self.w[f"{lvl}.in_proj.weight"].T + self.w[f"{lvl}.in_proj.bias"]
            cb = self.w[f"{lvl}.codebook"]
            c = (F.normalize(z_e, dim=-1) @ F.normalize(cb, dim=-1).T).argmax(dim=-1)
            if forced is not None:
                c = forced[i].long()
            out = cb[c] @ self.w[f"{lvl}.out_proj.weight"].T + self.w[f"{lvl}.out_proj.bias"]
            out = out.repeat_interleave(s, dim=1)
            residual, zq = residual - out, zq + out
            codes.append(c)
        return zq, codes
