"""SNAC 44 kHz (hubertsiuzdak/snac, ``snac/snac.py``, ``layers.py``,
``attention.py``, ``vq.py``) from its equations, in plain PyTorch and
numpy, at the precision of ``precision.py``: the reference of the
``snac44k-bf16`` configuration.  It imports nothing of the measured program.

The layers (C channels, (B, C, T) tensors, weights keyed by the program's
parameter names):

* ResidualUnit(C, d): x + Conv_k1(Snake(DWConv_k7,d(Snake(x)))), the
  depthwise conv (groups = C) padded 3 d on each side;
* EncoderBlock(C -> 2C, s): three residual units (d = 1, 3, 9), Snake, a
  conv of kernel 2 s, stride s and padding ceil(s / 2);
* the encoder: conv 1 -> 64 (k7), four blocks to 1024 channels, LocalMHA,
  a depthwise k7 conv; the decoder: a depthwise k7 conv, a k1 conv to 1536
  channels, LocalMHA, four blocks to 96 channels, Snake, conv to one
  channel (k7), tanh;
* DecoderBlock(C -> C / 2, s): Snake, a transposed conv (kernel 2 s,
  stride s, padding ceil(s / 2), output_padding s mod 2), NoiseBlock,
  three residual units;
* NoiseBlock(C): x + n Conv_k1,nobias(x), n (B, 1, T) standard normals;
* LocalMHA(D): LayerNorm over channels (eps 1e-5), q, k, v = x W_qkv (no
  bias), heads of 64, non-overlapping windows of ``attn_window`` frames,
  rotary positions 0 .. window - 1 in each window (inv_freq 10000^(-2i /
  64), the halves rotated, no xpos), softmax(q k^T / 8) v inside each
  window, W_out (no bias), plus the residual;
* Snake(x) = x + sin^2(a x) / (a + 1e-9);
* each VQ level: average-pool by its stride, in_proj, the code of highest
  cosine (vectors scaled by rsqrt(|v|^2 + 1e-8), the first on ties),
  out_proj, repeat stride times, subtract from the residual.

In bfloat16 the convs, Snakes, noise blocks and attention round their
operands and what they store to bfloat16 (the LayerNorm's statistics, the
rotary products and the softmax in float32); the VQ, the decoder's last
conv and tanh stay float32.

Departures from the published model, none of which changes a shape:

* weight norm is folded: every conv holds its plain weight;
* the noise is ``jax.random.normal`` of a threefry key (the program's keys,
  drawn here by :func:`normal`), not ``torch.randn``;
* Snake's alpha is exp(log_alpha), and its sin^2 the codec's polynomial
  (u = a x / pi reduced to [-1/2, 1/2] by round-half-even, sin(pi u) to
  p^7, squared), as the program computes them.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from . import threefry
from .precision import Precision

DIM_HEAD = 64
_U32 = np.uint32


# M. Giles, "Approximating the erfinv function" (GPU Computing Gems, 2011), its single-precision
# polynomials in w = -log(1 - x^2): w < 5 about w - 2.5, else about sqrt(w) - 3 (highest first)
_ERFINV_W_LO = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
                -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_W_HI = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
                -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def erfinv32(x: torch.Tensor) -> torch.Tensor:
    """erfinv of float32 |x| < 1 as ``jax.lax.erf_inv`` defines it in
    float32 (Giles' polynomials; near |x| = 1 it strays from the true
    function by up to 0.01, so ``torch.special.erfinv`` would not do)."""
    w = -torch.log1p(-x * x)
    lo = w < 5.0
    w = torch.where(lo, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.zeros_like(x)
    for c_lo, c_hi in zip(_ERFINV_W_LO, _ERFINV_W_HI):
        p = p * w + torch.where(lo, torch.tensor(c_lo), torch.tensor(c_hi))
    return p * x


def normal(key, shape, device="cpu") -> torch.Tensor:
    """``jax.random.normal(key, shape, float32)``: threefry bits of each
    element's row-major index (as a (hi, lo) counter pair, y1 ^ y2), their
    23 high bits as a uniform u over (-1, 1), sqrt(2) erf_inv(u) in
    float32."""
    n = int(np.prod(shape, dtype=np.int64))
    idx = np.arange(n, dtype=np.uint64)
    y1, y2 = threefry.threefry2x32(np.asarray(key, _U32), (idx >> np.uint64(32)).astype(_U32),
                                   (idx & np.uint64(0xFFFFFFFF)).astype(_U32))
    bits = ((y1 ^ y2) >> _U32(9)) | np.array(1.0, np.float32).view(_U32)
    unit = bits.view(np.float32).astype(np.float64) - 1.0
    lo = np.nextafter(np.float32(-1.0), np.float32(0.0))
    span = np.float32(1.0) - lo  # in float32: 2
    u = np.maximum(lo, unit * float(span) + float(lo)).astype(np.float32)  # one rounding: a multiply-add
    z = np.float32(math.sqrt(2.0)) * erfinv32(torch.from_numpy(u))
    return z.reshape(shape).to(device)


def sin2(z: torch.Tensor) -> torch.Tensor:
    u = z * (1.0 / math.pi)
    u = u - torch.round(u)
    p = u * math.pi
    p2 = p * p
    s = p * (1.0 - p2 / 6.0 * (1.0 - p2 / 20.0 * (1.0 - p2 / 42.0)))
    return s * s


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-8)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


def chunk(cfg: dict) -> int:
    """SNAC's ``preprocess``: pad to hop * lcm(vq_strides[0], attn_window)."""
    return math.prod(cfg["encoder_rates"]) * math.lcm(cfg["vq_strides"][0], cfg["attn_window"] or 1)


def pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return F.pad(x, (0, -x.shape[-1] % multiple))


class Snac:
    """The codec of `cfg` (the configuration file's ``codec`` block) on the
    weights `w` (name -> tensor), at precision `prec`."""

    def __init__(self, w: dict, cfg: dict, prec: Precision):
        self.w, self.cfg, self.p = w, cfg, prec

    # -- layers ----------------------------------------------------------
    def conv(self, name: str, x: torch.Tensor, stride: int = 1, dilation: int = 1,
             groups: int = 1, padding: int | None = None, wide: bool = False) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w.get(f"{name}.bias")
        if padding is None:
            padding = dilation * (w.shape[-1] - 1) // 2
        rnd = self.p.wide if wide else self.p.operand
        store = (lambda t: t) if wide else self.p.store
        y = F.conv1d(rnd(x), rnd(w), None, stride, padding, dilation, groups)
        return store(y if b is None else y + store(b)[:, None])

    def dwconv(self, name: str, x: torch.Tensor, dilation: int = 1) -> torch.Tensor:
        return self.conv(name, x, dilation=dilation, groups=x.shape[1])

    def snake(self, name: str, x: torch.Tensor) -> torch.Tensor:
        store = self.p.store
        a = store(torch.exp(self.w[f"{name}.log_alpha"]))[None, :, None]
        q = store(store(sin2(a * x)) / (a + 1e-9))
        return store(x + q)

    def residual_unit(self, name: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
        y = self.dwconv(f"{name}.Conv_0", self.snake(f"{name}.Snake_0", x), dilation)
        y = self.conv(f"{name}.Conv_1", self.snake(f"{name}.Snake_1", y))
        return self.p.store(x + y)

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        st, op = self.p.store, self.p.operand
        b, c, t = x.shape
        win, heads = self.cfg["attn_window"], c // DIM_HEAD
        y = st(F.layer_norm(x.transpose(1, 2), (c,), st(self.w[f"{name}.norm.weight"]),
                            st(self.w[f"{name}.norm.bias"]), 1e-5))
        qkv = st(op(y) @ op(self.w[f"{name}.to_qkv.weight"]).T)
        # b (w n) (h d) -> b w h n d
        q, k, v = (u.reshape(b, t // win, win, heads, DIM_HEAD).transpose(2, 3)
                   for u in qkv.chunk(3, dim=-1))
        inv_freq = 1.0 / 10000 ** (torch.arange(0, DIM_HEAD, 2, device=x.device).float() / DIM_HEAD)
        freqs = torch.arange(win, device=x.device).float()[:, None] * inv_freq
        freqs = torch.cat((freqs, freqs), dim=-1)
        q = st(q * freqs.cos() + rotate_half(q) * freqs.sin())
        k = st(k * freqs.cos() + rotate_half(k) * freqs.sin())
        att = torch.softmax((op(q) @ op(k).transpose(-1, -2)) / math.sqrt(DIM_HEAD), dim=-1)
        o = st(op(att) @ op(v)).transpose(2, 3).reshape(b, t, c)
        out = st(op(o) @ op(self.w[f"{name}.to_out.weight"]).T)
        return st(x + out.transpose(1, 2))

    def noise_block(self, name: str, x: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
        h = self.conv(f"{name}.Conv_0", x)
        return self.p.store(x + self.p.store(n) * h)

    def conv_transpose(self, name: str, x: torch.Tensor, s: int) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        y = F.conv_transpose1d(self.p.operand(x), self.p.operand(w), None, s, math.ceil(s / 2), s % 2)
        return self.p.store(y + self.p.store(b)[:, None])

    # -- encoder / decoder -----------------------------------------------
    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T / hop, latent_dim) float32."""
        h = self.conv("encoder.Conv_0", self.p.store(wav)[:, None, :])
        for i, s in enumerate(self.cfg["encoder_rates"]):
            blk = f"encoder.EncoderBlock_{i}"
            for j, d in enumerate((1, 3, 9)):
                h = self.residual_unit(f"{blk}.ResidualUnit_{j}", h, d)
            h = self.conv(f"{blk}.Conv_0", self.snake(f"{blk}.Snake_0", h), stride=s,
                          padding=math.ceil(s / 2))
        h = self.dwconv("encoder.DWConv_0", self.attention("encoder.LocalMHA_0", h))
        return h.transpose(1, 2)

    def decode_latent(self, z: torch.Tensor, noise) -> torch.Tensor:
        """(B, T', latent_dim) and a (B, 1, T) float32 noise a block ->
        (B, T) float32 in (-1, 1)."""
        h = self.dwconv("decoder.DWConv_0", self.p.store(z.transpose(1, 2)))
        h = self.attention("decoder.LocalMHA_0", self.conv("decoder.Conv_0", h))
        for i, s in enumerate(self.cfg["decoder_rates"]):
            blk = f"decoder.DecoderBlock_{i}"
            h = self.conv_transpose(f"{blk}.ConvTranspose_0", self.snake(f"{blk}.Snake_0", h), s)
            h = self.noise_block(f"{blk}.NoiseBlock_0", h, noise[i])
            for j, d in enumerate((1, 3, 9)):
                h = self.residual_unit(f"{blk}.ResidualUnit_{j}", h, d)
        h = self.snake("decoder.Snake_0", h)
        return torch.tanh(self.conv("decoder.Conv_1", h, wide=True))[:, 0]

    # -- residual VQ -----------------------------------------------------
    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        return self.p.wide(x) @ self.p.wide(w).T + b

    def quantize(self, z: torch.Tensor, forced=None):
        """z (B, T', D) -> (z_q, codes [(B, T'/s)], gaps [(B, T'/s)]); with
        `forced` (another path's codes, one tensor a level) the levels follow
        those codes, and each gap is how far the forced code's cosine lies
        below the best one's."""
        b, t, d = z.shape
        residual, zq, codes, gaps = z, torch.zeros_like(z), [], []
        for i, s in enumerate(self.cfg["vq_strides"]):
            lvl = f"quantizer.level_{i}"
            pooled = residual.reshape(b, t // s, s, d).mean(dim=2) if s > 1 else residual
            z_e = self.linear(f"{lvl}.in_proj", pooled)
            cb = self.w[f"{lvl}.codebook"]
            scores = self.p.wide(l2n(z_e)) @ self.p.wide(l2n(cb)).T
            best, arg = scores.max(dim=-1)
            c = arg if forced is None else forced[i].long()
            gaps.append(best - scores.gather(-1, c[..., None])[..., 0])
            out = self.linear(f"{lvl}.out_proj", cb[c])
            out = torch.repeat_interleave(out, s, dim=1) if s > 1 else out
            residual, zq = residual - out, zq + out
            codes.append(c)
        return zq, codes, gaps


def lalm_attack(codec: Snac, wav: torch.Tensor, noise, forced=None) -> dict:
    """The codec round trip as an attack: each clip scaled to peak 0.7 (its
    peak taken as at least 1e-4), zero-padded to SNAC's chunk, encoded,
    quantized, decoded with `noise` (one tensor a decoder block), scaled back
    and cut to its length.  -> {"attacked" (B, T), "decoded" (B, padded T),
    "latent" (B, T', D), "codes", "gaps"}."""
    g = 0.7 / torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-4)
    latent = codec.encode_latent(pad_to(wav * g, chunk(codec.cfg)))
    zq, codes, gaps = codec.quantize(latent, forced)
    decoded = codec.decode_latent(zq, noise)
    return {"attacked": (decoded / g)[:, : wav.shape[-1]], "decoded": decoded,
            "latent": latent, "codes": codes, "gaps": gaps}
