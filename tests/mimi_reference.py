"""Mimi (kyutai/mimi; the ``moshi`` package's ``models/loaders.py``,
``modules/seanet.py``, ``conv.py``, ``resample.py``, ``transformer.py``,
``quantization/vq.py``) from its equations, in plain PyTorch with TF32
off: the reference that ``tests/test_torch_mimi.py`` holds the port's Mimi
layout to, in float32 and at bfloat16's rounding points.  It imports
nothing of the port or of JAX; ``port_bench/reference/mimi.py`` is its
copy for the benchmark, at the benchmark's precisions.

The layers ((B, C, T) tensors; weights keyed by the program's parameter
names; ELU at alpha 1):

* causal conv (k, stride s, dilation d): d (k - 1) - (s - 1) zeros on the
  left and -T mod s on the right (the downsampler repeats the edge sample
  instead), then the conv; causal transposed conv (k = 2 s): the full
  output with its last k - s samples cut;
* ResBlock(C): x + Conv_k1(C/2 -> C)(ELU(Conv_k3(C -> C/2)(ELU(x))));
* encoder: Conv_k7(1 -> 64); for s in 4, 5, 6, 8: ResBlock(C), ELU,
  Conv(C -> 2C, k 2 s, stride s); ELU, Conv_k3(1024 -> 512); the encoder
  transformer; the downsampler Conv(512 -> 512, k4, stride 2, no bias);
* decoder: the upsampler ConvTranspose(512 -> 512, k4, stride 2, groups
  512, no bias); the decoder transformer; Conv_k7(512 -> 1024); for s in 8,
  6, 5, 4: ELU, ConvTranspose(C -> C/2, k 2 s, stride s), ResBlock(C/2);
  ELU, Conv_k3(64 -> 1); no tanh;
* transformer layer, on (B, T, C): x + g1 (Attn(LN1(x))), then
  x + g2 (W2 GELU(W1 LN2(x))); LayerNorm eps 1e-5, no biases, no final
  norm; Attn: q, k, v = x W_in, heads of C / heads, RoPE at frame
  positions 0 .. T - 1 (inv_freq 10000^(-2i / d_head), halves rotated),
  softmax(q k^T / sqrt(d_head)) over keys 0 <= t_q - t_k < context, W_out;
* split RVQ: the semantic and the acoustic quantizer each take the latent
  through its in_proj (no bias); each level takes the code at the least
  squared distance and subtracts it; the quantized latent is the sum of
  the two out_projs of the summed codewords.

In bfloat16 the convs, ELU, the transformer's products and LayerScale
round their operands and what they store to bfloat16 (the LayerNorm's
statistics, the RoPE products and the softmax in float32); the RVQ and the
decoder's last conv stay float32 (``wide``).

Departures from the published model, none of which changes a shape:

* weight norm and the codebooks' EMA buffers are folded into plain
  weights;
* RoPE rotates halves (``transformers``' form), where moshi rotates
  interleaved pairs: a fixed permutation of the q and k rows;
* the weights are drawn (by the tests).
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


@dataclasses.dataclass(frozen=True)
class Precision:
    """Roundings: the operands of every conv and product (``operand``),
    what a layer stores (``store``), the operands of what stays float32
    (``wide``)."""

    operand: object
    store: object
    wide: object = _same


PRECISIONS = {"float32": Precision(_same, _same), "bfloat16": Precision(_bf16, _bf16)}


def chunk(cfg: dict) -> int:
    """One frame of the quantizer, hop x the resampler's stride."""
    return math.prod(cfg["encoder_rates"]) * cfg["resample_stride"]


def pad_to(x: torch.Tensor, multiple: int) -> torch.Tensor:
    return F.pad(x, (0, -x.shape[-1] % multiple))


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat((-x2, x1), dim=-1)


class Mimi:
    """The codec of `cfg` (the configuration file's ``codec`` block) on the
    weights `w` (name -> tensor), at precision `prec`."""

    def __init__(self, w: dict, cfg: dict, prec: Precision):
        self.w, self.cfg, self.p = w, cfg, prec
        self.heads, self.context = cfg["tfm_heads"], cfg["tfm_context"]

    # -- convs -------------------------------------------------------------
    def conv(self, name: str, x: torch.Tensor, stride: int = 1, replicate: bool = False,
             wide: bool = False) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w.get(f"{name}.bias")
        k = w.shape[-1]
        x = F.pad(x, (k - stride, -x.shape[-1] % stride), mode="replicate" if replicate else "constant")
        rnd, store = (self.p.wide, lambda t: t) if wide else (self.p.operand, self.p.store)
        y = store(F.conv1d(rnd(x), rnd(w), None, stride))
        return y if b is None else store(y + store(b)[:, None])

    def conv_transpose(self, name: str, x: torch.Tensor, stride: int, groups: int = 1) -> torch.Tensor:
        w, b = self.w[f"{name}.weight"], self.w.get(f"{name}.bias")
        op, st = self.p.operand, self.p.store
        y = st(F.conv_transpose1d(op(x), op(w), None, stride, 0, 0, groups))[..., : x.shape[-1] * stride]
        return y if b is None else st(y + st(b)[:, None])

    def elu(self, x: torch.Tensor) -> torch.Tensor:
        return self.p.store(F.elu(x))

    def res_block(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(f"{name}.Conv_0", self.elu(x))
        y = self.conv(f"{name}.Conv_1", self.elu(y))
        return self.p.store(x + y)

    def seanet_encoder(self, x: torch.Tensor) -> torch.Tensor:
        """(B, 1, T) -> (B, latent_dim, T / hop)."""
        h = self.conv("encoder.seanet.Conv_0", x)
        for i, s in enumerate(self.cfg["encoder_rates"]):
            blk = f"encoder.seanet.Block_{i}"
            h = self.conv(f"{blk}.Conv_0", self.elu(self.res_block(f"{blk}.Res", h)), stride=s)
        return self.conv("encoder.seanet.Conv_1", self.elu(h))

    def seanet_decoder(self, h: torch.Tensor) -> torch.Tensor:
        """(B, latent_dim, T') -> (B, T' hop) float32."""
        h = self.conv("decoder.seanet.Conv_0", h)
        for i, s in enumerate(self.cfg["decoder_rates"]):
            blk = f"decoder.seanet.Block_{i}"
            h = self.res_block(f"{blk}.Res", self.conv_transpose(f"{blk}.ConvTranspose_0", self.elu(h), s))
        return self.conv("decoder.seanet.Conv_1", self.elu(h), wide=True)[:, 0]

    # -- transformer -------------------------------------------------------
    def layer_norm(self, name: str, x: torch.Tensor) -> torch.Tensor:
        st = self.p.store
        return st(F.layer_norm(x, (x.shape[-1],), st(self.w[f"{name}.weight"]), st(self.w[f"{name}.bias"]),
                               1e-5))

    def linear(self, name: str, x: torch.Tensor) -> torch.Tensor:
        op = self.p.operand
        return self.p.store(op(x) @ op(self.w[f"{name}.weight"]).T)

    def scaled(self, name: str, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        st = self.p.store
        return st(x + st(st(self.w[f"{name}.scale"]) * y))

    def attention(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """One layer's x + g Attn(LN(x)) on (B, T, C)."""
        st, op = self.p.store, self.p.operand
        b, t, c = x.shape
        h = self.heads
        dh = c // h
        qkv = self.linear(f"{name}.in_proj", self.layer_norm(f"{name}.norm", x))
        q, k, v = qkv.view(b, t, 3, h, dh).permute(2, 0, 3, 1, 4)
        inv_freq = 10000.0 ** (-torch.arange(0, dh, 2, device=x.device, dtype=torch.float32) / dh)
        freqs = torch.arange(t, device=x.device, dtype=torch.float32)[:, None] * inv_freq
        freqs = torch.cat((freqs, freqs), dim=-1)
        cos, sin = freqs.cos(), freqs.sin()
        q = st(q * cos + rotate_half(q) * sin)
        k = st(k * cos + rotate_half(k) * sin)
        delta = torch.arange(t, device=x.device)[:, None] - torch.arange(t, device=x.device)[None, :]
        allowed = (delta >= 0) & (delta < self.context)
        scores = (op(q) @ op(k).transpose(-1, -2)) / math.sqrt(dh)
        att = torch.softmax(scores.masked_fill(~allowed, float("-inf")), dim=-1)
        o = st(op(att) @ op(v)).transpose(1, 2).reshape(b, t, c)
        return self.scaled(name, x, self.linear(f"{name}.out_proj", o))

    def feed_forward(self, name: str, x: torch.Tensor) -> torch.Tensor:
        y = self.linear(f"{name}.fc1", self.layer_norm(f"{name}.norm", x))
        return self.scaled(name, x, self.linear(f"{name}.fc2", self.p.store(F.gelu(y))))

    def transformer(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, C, T)."""
        h = x.transpose(1, 2)
        for i in range(self.cfg["tfm_layers"]):
            h = self.feed_forward(f"{name}.layers.{i}.mlp", self.attention(f"{name}.layers.{i}.attn", h))
        return h.transpose(1, 2)

    # -- the codec's stages ----------------------------------------------
    def downsample(self, h: torch.Tensor) -> torch.Tensor:
        """(B, C, T) -> (B, T / s, C) float32 latent."""
        s = self.cfg["resample_stride"]
        return self.conv("encoder.downsample", h, stride=s, replicate=True).transpose(1, 2).float()

    def upsample(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T', C) float32 -> (B, C, T' s)."""
        c = z.shape[-1]
        return self.conv_transpose("decoder.upsample", self.p.store(z.transpose(1, 2)),
                                   self.cfg["resample_stride"], groups=c)

    def encode_latent(self, wav: torch.Tensor) -> dict:
        """(B, T) -> {"seanet", "enc_tfm", "latent"}."""
        h = self.seanet_encoder(self.p.store(wav)[:, None, :])
        t = self.transformer("encoder.transformer", h)
        return {"seanet": h, "enc_tfm": t, "latent": self.downsample(t)}

    def decode_latent(self, z: torch.Tensor) -> dict:
        """(B, T', C) -> {"upsampled", "dec_tfm", "decoded"}."""
        u = self.upsample(z)
        t = self.transformer("decoder.transformer", u)
        return {"upsampled": u, "dec_tfm": t, "decoded": self.seanet_decoder(t)}

    # -- split RVQ ---------------------------------------------------------
    def quantize(self, z: torch.Tensor, forced=None):
        """z (B, T', D) -> (z_q, codes [(B, T')], gaps [(B, T')]); with
        `forced` (another path's codes, one tensor a level) the levels follow
        those codes, and each gap is how far the forced code's squared
        distance lies above the least one, over the least one (float64)."""
        wide = self.p.wide
        n_sem, n_q = self.cfg["semantic_levels"], self.cfg["n_q"]
        zq, codes, gaps = 0.0, [], []
        for q, levels in (("semantic", range(n_sem)), ("acoustic", range(n_q - n_sem))):
            r = wide(z) @ wide(self.w[f"quantizer.{q}.in_proj.weight"]).T
            total = torch.zeros_like(r)
            for i in levels:
                cb = self.w[f"quantizer.{q}.levels.{i}.codebook"]
                r64, c64 = r.double(), cb.double()
                d = (r64 * r64).sum(-1, keepdim=True) + (c64 * c64).sum(-1) - 2.0 * r64 @ c64.T
                best = d.min(dim=-1)
                c = d.argmin(dim=-1) if forced is None else forced[len(codes)].long()
                chosen = d.gather(-1, c[..., None])[..., 0]
                gaps.append((chosen - best.values) / best.values.clamp(min=1e-300))
                r, total = r - cb[c], total + cb[c]
                codes.append(c)
            zq = zq + wide(total) @ wide(self.w[f"quantizer.{q}.out_proj.weight"]).T
        return zq, codes, gaps


def lalm_attack(codec: Mimi, wav: torch.Tensor, forced=None) -> dict:
    """The codec round trip as an attack: each clip scaled to peak 0.7 (its
    peak taken as at least 1e-4), zero-padded to a frame, encoded,
    quantized, decoded, scaled back and cut to its length."""
    g = 0.7 / torch.clamp(wav.abs().amax(dim=-1, keepdim=True), min=1e-4)
    enc = codec.encode_latent(pad_to(wav * g, chunk(codec.cfg)))
    zq, codes, gaps = codec.quantize(enc["latent"], forced)
    dec = codec.decode_latent(zq)
    return {**enc, **dec, "attacked": (dec["decoded"] / g)[:, : wav.shape[-1]], "codes": codes,
            "gaps": gaps, "zq": zq}
