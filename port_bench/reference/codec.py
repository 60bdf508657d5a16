"""The SNAC-style codec from its definition: conv encoder -> multi-scale
residual VQ -> conv decoder, in plain PyTorch.

The layers, as the JAX package defines them (``nawc_tpu/codec/``):

* a conv has flax's "SAME" padding: output length ceil(T / stride), the
  total padding split with the smaller half on the left; its weight is
  (out, in, k), y[o, t] = b[o] + sum_{i, j} w[o, i, j] x[i, t s + j d - left];
* a transposed conv (kernel 2 s, stride s) is ``lax.conv_transpose`` with
  "SAME" padding: the input dilated by s, padded by (ceil((3s - 2) / 2),
  floor((3s - 2) / 2)) and correlated with the kernel.  Its weight is kept
  as (in, out, k) with the taps in reverse, so the kernel that correlates
  is w[i, o, k - 1 - j];
* Snake(x) = x + sin^2(a x) / (a + 1e-9), a = exp(log_alpha) per channel,
  with the codec's own sin^2: u = a x / pi reduced to [-1/2, 1/2] by
  round-half-even, p = pi u, sin p by its Taylor polynomial to p^7, squared;
* a residual unit x + Conv_1(Snake_1(Conv_0(Snake_0(x)))), kernel 7 with
  dilation 1, 3 or 9, then kernel 1;
* an encoder block: three residual units, Snake, a strided conv (kernel
  2 s); a decoder block: Snake, a transposed conv, three residual units;
* the encoder: conv k7, the blocks, Snake, conv k3 to the latent; the
  decoder: conv k7, the blocks, Snake, conv k7 to one channel, tanh;
* each VQ level pools the residual by its stride (mean), projects it
  (in_proj), takes the codebook entry of highest cosine (vectors scaled by
  rsqrt(|v|^2 + 1e-8); the first on ties), projects it back (out_proj),
  repeats it stride times and subtracts it from the residual.

A bfloat16 configuration runs the convs and Snakes in bfloat16 and keeps
the VQ and the decoder's last conv in float32 (``precision.py``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .precision import Precision


def same_padding(t: int, k: int, s: int = 1, d: int = 1) -> tuple[int, int]:
    out = -(-t // s)
    total = max((out - 1) * s + d * (k - 1) + 1 - t, 0)
    return total // 2, total - total // 2


def sin2(z: torch.Tensor) -> torch.Tensor:
    u = z * (1.0 / math.pi)
    u = u - torch.round(u)
    p = u * math.pi
    p2 = p * p
    s = p * (1.0 - p2 / 6.0 * (1.0 - p2 / 20.0 * (1.0 - p2 / 42.0)))
    return s * s


def l2n(x: torch.Tensor) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-8)


def _ste(x: torch.Tensor, rounded: torch.Tensor) -> torch.Tensor:
    """`rounded` forward, the identity backward."""
    return x + (rounded - x).detach()


class Codec:
    """The codec of `cfg` (the configuration file's ``codec`` block) on
    the weights `w` (name -> tensor), at precision `prec`."""

    def __init__(self, w: dict, cfg: dict, prec: Precision):
        self.w, self.cfg, self.p = w, cfg, prec
        self.wide = prec.wide

    # -- layers ----------------------------------------------------------
    def _op(self, x, fn):
        return _ste(x, fn(x)) if x.requires_grad else fn(x)

    def conv(self, name: str, x: torch.Tensor, stride: int = 1, dilation: int = 1,
             wide: bool = False) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        left, right = same_padding(x.shape[-1], w.shape[-1], stride, dilation)
        rnd = self.wide if wide else self.p.operand
        store = (lambda t: t) if wide else self.p.store
        y = F.conv1d(F.pad(self._op(x, rnd), (left, right)), rnd(w), None, stride, 0, dilation)
        return self._op(y + store(b)[:, None], store)

    def conv_transpose(self, name: str, x: torch.Tensor, stride: int) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        k = w.shape[-1]
        pad_len = k + stride - 2
        left = -(-pad_len // 2)
        bsz, c, t = x.shape
        xd = x.new_zeros((bsz, c, (t - 1) * stride + 1))
        xd = xd.index_copy(2, torch.arange(0, xd.shape[-1], stride, device=x.device),
                           self._op(x, self.p.operand))
        kern = self.p.operand(w).flip(-1).transpose(0, 1)  # (out, in, k) correlating taps
        y = F.conv1d(F.pad(xd, (left, pad_len - left)), kern)
        return self._op(y + self.p.store(b)[:, None], self.p.store)

    def snake(self, name: str, x: torch.Tensor) -> torch.Tensor:
        store = self.p.store
        a = store(torch.exp(self.w[f"{name}.log_alpha"]))[None, :, None]
        s2 = self._op(sin2(a * x), store)
        q = self._op(s2 / (a + 1e-9), store)
        return self._op(x + q, store)

    def residual_unit(self, name: str, x: torch.Tensor, dilation: int) -> torch.Tensor:
        y = self.conv(f"{name}.Conv_0", self.snake(f"{name}.Snake_0", x), dilation=dilation)
        y = self.conv(f"{name}.Conv_1", self.snake(f"{name}.Snake_1", y))
        return self._op(x + y, self.p.store)

    # -- encoder / decoder -----------------------------------------------
    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T / hop, latent_dim) float32."""
        h = self.conv("encoder.Conv_0", self._op(wav, self.p.store)[:, None, :])
        for i, rate in enumerate(self.cfg["encoder_rates"]):
            blk = f"encoder.EncoderBlock_{i}"
            for j, dil in enumerate((1, 3, 9)):
                h = self.residual_unit(f"{blk}.ResidualUnit_{j}", h, dil)
            h = self.conv(f"{blk}.Conv_0", self.snake(f"{blk}.Snake_0", h), stride=rate)
        h = self.conv("encoder.Conv_1", self.snake("encoder.Snake_0", h))
        return h.transpose(1, 2)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T', latent_dim) -> (B, T) float32 in (-1, 1)."""
        h = self.conv("decoder.Conv_0", self._op(z.transpose(1, 2), self.p.store))
        for i, rate in enumerate(self.cfg["decoder_rates"]):
            blk = f"decoder.DecoderBlock_{i}"
            h = self.conv_transpose(f"{blk}.ConvTranspose_0", self.snake(f"{blk}.Snake_0", h), rate)
            for j, dil in enumerate((1, 3, 9)):
                h = self.residual_unit(f"{blk}.ResidualUnit_{j}", h, dil)
        h = self.snake("decoder.Snake_0", h)
        return torch.tanh(self.conv("decoder.Conv_1", h, wide=True))[:, 0]

    # -- residual VQ -----------------------------------------------------
    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w[f"{name}.bias"]
        return self._op(x, self.wide) @ self.wide(w).T + b

    def project(self, z: torch.Tensor) -> torch.Tensor:
        """The first level's in_proj of the latents (B, T', D) -> (B, T', C)."""
        return self.linear("quantizer.level_0.in_proj", z)

    def quantize(self, z: torch.Tensor, forced=None):
        """z (B, T', D) -> (z_q (B, T', D), codes [(B, T'/s)], gaps [(B, T'/s)]).

        With `forced` (the codes another path chose, one tensor a level) the
        levels follow those codes, and each gap is how far the forced code's
        cosine lies below the best one's; without, the gaps are 0."""
        b, t, d = z.shape
        residual, zq, codes, gaps = z, torch.zeros_like(z), [], []
        for i, s in enumerate(self.cfg["vq_strides"]):
            lvl = f"quantizer.level_{i}"
            pooled = residual.reshape(b, t // s, s, d).mean(dim=2) if s > 1 else residual
            z_e = self.linear(f"{lvl}.in_proj", pooled)
            cb = self.w[f"{lvl}.codebook"]
            scores = self.wide(l2n(z_e)) @ self.wide(l2n(cb)).T
            best, arg = scores.max(dim=-1)
            c = arg if forced is None else forced[i].long()
            gaps.append(best - scores.gather(-1, c[..., None])[..., 0])
            out = self.linear(f"{lvl}.out_proj", cb[c])
            if s > 1:
                out = torch.repeat_interleave(out, s, dim=1)
            out = out[:, :t]
            residual = residual - out
            zq = zq + out
            codes.append(c)
        return zq, codes, gaps


def chunk(cfg: dict) -> int:
    """The pad-to multiple: hop times the largest VQ stride, at least 4096."""
    return max(4096, math.prod(cfg["encoder_rates"]) * max(cfg["vq_strides"]))


def pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return F.pad(x, (0, -x.shape[-1] % multiple))


def lalm_attack(codec: Codec, wav: torch.Tensor, forced=None) -> dict:
    """The codec round trip as an attack: each clip scaled to peak 0.7
    (its peak taken as at least 1e-4), zero-padded to the chunk, encoded,
    quantized, decoded, scaled back and cut to its length.
    -> {"attacked" (B, T), "decoded" (B, padded T), "latent" (B, T', D),
    "codes", "gaps"}."""
    g = 0.7 / torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-4)
    latent = codec.encode_latent(pad_to(wav * g, chunk(codec.cfg)))
    zq, codes, gaps = codec.quantize(latent, forced)
    decoded = codec.decode_latent(zq)
    return {"attacked": (decoded / g)[:, : wav.shape[-1]], "decoded": decoded,
            "latent": latent, "codes": codes, "gaps": gaps}
