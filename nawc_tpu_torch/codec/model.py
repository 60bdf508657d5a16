"""SNAC-style neural audio codec (``nawc_tpu/codec/model.py``): conv encoder
-> multi-scale residual VQ -> conv decoder.

Public methods keep the JAX package's layouts: waveforms (B, T), latents
(B, T', latent_dim), codes [(B, T'/stride_i)].  Inside, convolutions run in
(B, C, T).  Module names follow flax's (``level_0``, ``EncoderBlock_2``, ...).

In SNAC's layout (``cfg.layout == "snac"``, after the ``snac`` package's
``Encoder`` and ``Decoder``) the encoder ends in windowed attention
(``LocalMHA_0``) and a k7 conv ``DWConv_0`` (depthwise where
``cfg.depthwise``), and the decoder starts with ``DWConv_0``, a conv
``Conv_0`` (k1 after a depthwise conv, else k7) and ``LocalMHA_0``; its
blocks hold noise blocks where ``cfg.noise_blocks``.

The encoder and decoder compute in ``cfg.compute_dtype`` as the JAX modules
do: a bfloat16 codec casts the waveform (encoder) or the latent (decoder) to
bfloat16 and runs every conv and Snake in it; the latent comes out float32,
and the decoder's last conv and ``tanh`` run in float32 (flax promotes that
conv, which has no ``dtype``, to its float32 kernel; on the card
``csrc/outconv.cu`` computes it from the bfloat16 activation in place).  The
residual VQ is float32 in both.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn as nn

from ..ops.rvq import nearest_codebook
from ..utils import profiling
from ..utils.config import CodecConfig
from .layers import DecoderBlock, EncoderBlock, LocalMHA, NoiseKey, SameConv1d, Snake


def _dwconv(cfg: CodecConfig, dim: int) -> SameConv1d:
    """SNAC's k7 conv at `dim` channels: depthwise where ``cfg.depthwise``."""
    return SameConv1d(dim, dim, 7, groups=dim if cfg.depthwise else 1)


class Encoder(nn.Module):
    def __init__(self, cfg: CodecConfig):
        super().__init__()
        snac = cfg.layout == "snac"
        self.Conv_0 = SameConv1d(1, cfg.encoder_dim, 7)
        dim = cfg.encoder_dim
        for i, rate in enumerate(cfg.encoder_rates):
            self.add_module(f"EncoderBlock_{i}",
                            EncoderBlock(dim, dim * 2, rate, depthwise=cfg.depthwise, snac=snac))
            dim *= 2
        if snac:
            if cfg.attn_window:
                self.LocalMHA_0 = LocalMHA(dim, cfg.attn_window)
            self.DWConv_0 = _dwconv(cfg, dim)
        else:
            self.Snake_0 = Snake(dim)
            self.Conv_1 = SameConv1d(dim, cfg.latent_dim, 3)
        self.snac = snac
        self.n_blocks = len(cfg.encoder_rates)
        self.dtype = cfg.compute_torch_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, T) waveform -> (B, T/hop, latent_dim) float32 latents."""
        with profiling.annotate("codec.encode", x.device):
            h = self.Conv_0(x[:, None, :].to(self.dtype))
            for i in range(self.n_blocks):
                h = getattr(self, f"EncoderBlock_{i}")(h)
            if self.snac:
                if hasattr(self, "LocalMHA_0"):
                    h = self.LocalMHA_0(h)
                h = self.DWConv_0(h)
            else:
                h = self.Conv_1(self.Snake_0(h))
            return h.transpose(1, 2).float()


class Decoder(nn.Module):
    def __init__(self, cfg: CodecConfig):
        super().__init__()
        snac = cfg.layout == "snac"
        if snac and cfg.depthwise:
            self.DWConv_0 = _dwconv(cfg, cfg.latent_dim)
            self.Conv_0 = SameConv1d(cfg.latent_dim, cfg.decoder_dim, 1)
        else:
            self.Conv_0 = SameConv1d(cfg.latent_dim, cfg.decoder_dim, 7)
        if snac and cfg.attn_window:
            self.LocalMHA_0 = LocalMHA(cfg.decoder_dim, cfg.attn_window)
        self.noise = NoiseKey() if cfg.noise_blocks else None
        dim = cfg.decoder_dim
        for i, rate in enumerate(cfg.decoder_rates):
            self.add_module(f"DecoderBlock_{i}",
                            DecoderBlock(dim, dim // 2, rate, depthwise=cfg.depthwise, snac=snac,
                                         noise=self.noise))
            dim //= 2
        self.Snake_0 = Snake(dim)
        self.Conv_1 = SameConv1d(dim, 1, 7, widen=True)
        self.n_blocks = len(cfg.decoder_rates)
        self.dtype = cfg.compute_torch_dtype

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, T/hop, latent_dim) -> (B, T) float32 waveform in [-1, 1]."""
        with profiling.annotate("codec.decode", z.device):
            h = z.transpose(1, 2).to(self.dtype)
            if hasattr(self, "DWConv_0"):
                h = self.DWConv_0(h)
            h = self.Conv_0(h)
            if hasattr(self, "LocalMHA_0"):
                h = self.LocalMHA_0(h)
            for i in range(self.n_blocks):
                h = getattr(self, f"DecoderBlock_{i}")(h)
            h = self.Conv_1(self.Snake_0(h))
            return torch.tanh(h)[:, 0]


class VQLevel(nn.Module):
    """One residual-VQ level operating at temporal stride `stride`."""

    def __init__(self, cfg: CodecConfig, stride: int):
        super().__init__()
        self.stride = stride
        self.in_proj = nn.Linear(cfg.latent_dim, cfg.codebook_dim)
        self.out_proj = nn.Linear(cfg.codebook_dim, cfg.latent_dim)
        self.codebook = nn.Parameter(torch.zeros(cfg.codebook_size, cfg.codebook_dim))

    def encode(self, residual: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """residual (B, T', D) -> (codes (B, T'/s), z_e (B, T'/s, cb_dim))."""
        z = residual
        if self.stride > 1:
            b, t, d = z.shape
            z = z.reshape(b, t // self.stride, self.stride, d).mean(dim=2)
        z_e = self.in_proj(z)
        return nearest_codebook(z_e, self.codebook), z_e

    def _expand(self, out: torch.Tensor, out_len: int) -> torch.Tensor:
        if self.stride > 1:
            out = torch.repeat_interleave(out, self.stride, dim=1)
        return out[:, :out_len]

    def dequantize(self, codes: torch.Tensor, out_len: int) -> torch.Tensor:
        """codes (B, T'/s) -> (B, out_len, latent_dim) contribution."""
        return self._expand(self.out_proj(self.codebook[codes.long()]), out_len)

    def forward(self, residual: torch.Tensor):
        """Straight-through quantisation of one level -> (contribution at the
        full latent rate, codes, commitment loss, codebook loss)."""
        codes, z_e = self.encode(residual)
        z_q = self.codebook[codes.long()]
        commit = torch.mean((z_e - z_q.detach()) ** 2)
        codebook_loss = torch.mean((z_q - z_e.detach()) ** 2)
        # the STE expression, kept as written: in f32 it is not bit-identical
        # to z_q, and the round-trip goes through it
        z_q = z_e + (z_q - z_e).detach()
        return self._expand(self.out_proj(z_q), residual.shape[1]), codes, commit, codebook_loss


class ResidualVQ(nn.Module):
    def __init__(self, cfg: CodecConfig):
        super().__init__()
        self.n_levels = len(cfg.vq_strides)
        for i, s in enumerate(cfg.vq_strides):
            self.add_module(f"level_{i}", VQLevel(cfg, s))

    @property
    def levels(self) -> list[VQLevel]:
        return [getattr(self, f"level_{i}") for i in range(self.n_levels)]

    def forward(self, z: torch.Tensor):
        """z (B, T', D) -> (z_q, codes list, commit loss, codebook loss)."""
        with profiling.annotate("codec.quantize", z.device):
            residual = z
            z_q = torch.zeros_like(z)
            codes = []
            commit = 0.0
            cb_loss = 0.0
            for level in self.levels:
                out, c, cm, cb = level(residual)
                residual = residual - out.detach()
                z_q = z_q + out
                codes.append(c)
                commit = commit + cm
                cb_loss = cb_loss + cb
            return z_q, codes, commit, cb_loss

    def encode(self, z: torch.Tensor) -> list[torch.Tensor]:
        with profiling.annotate("codec.quantize", z.device):
            residual = z
            codes = []
            for level in self.levels:
                c, _ = level.encode(residual)
                residual = residual - level.dequantize(c, residual.shape[1])
                codes.append(c)
            return codes

    def from_codes(
        self, codes: Sequence[torch.Tensor], out_len: int, level_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        """codes -> z_q; `level_mask` (num_levels,) zeroes levels (ablation)."""
        with profiling.annotate("codec.quantize", codes[0].device):
            z_q = None
            for i, level in enumerate(self.levels):
                out = level.dequantize(codes[i], out_len)
                if level_mask is not None:
                    out = out * level_mask[i]
                z_q = out if z_q is None else z_q + out
            return z_q


class SnacCodec(nn.Module):
    """Full codec."""

    def __init__(self, cfg: CodecConfig = CodecConfig()):
        super().__init__()
        if cfg.layout == "mimi":
            raise ValueError("SnacCodec: the 'mimi' layout is MimiCodec's (codec/mimi.py)")
        self.cfg = cfg
        self.encoder = Encoder(cfg)
        self.quantizer = ResidualVQ(cfg)
        self.decoder = Decoder(cfg)

    def seed_noise(self, seed: int) -> None:
        """Restart the noise blocks' keys from `seed` (no-op without them)."""
        if self.decoder.noise is not None:
            self.decoder.noise.seed(seed)

    def forward(self, wav: torch.Tensor) -> dict:
        """Training forward: (B, T) -> dict with recon + VQ losses."""
        z = self.encoder(wav)
        z_q, codes, commit, cb_loss = self.quantizer(z)
        return {
            "recon": self.decoder(z_q),
            "codes": codes,
            "latent": z,
            "commit_loss": commit,
            "codebook_loss": cb_loss,
        }

    def encode_latent(self, wav: torch.Tensor) -> torch.Tensor:
        return self.encoder(wav)

    def decode_latent(self, z: torch.Tensor) -> torch.Tensor:
        return self.decoder(z)

    def encode(self, wav: torch.Tensor) -> list[torch.Tensor]:
        """(B, T) -> per-level codes (B, T/hop/stride_i), unfused."""
        return self.quantizer.encode(self.encoder(wav))

    def decode(
        self, codes: Sequence[torch.Tensor], level_mask: torch.Tensor | None = None
    ) -> torch.Tensor:
        out_len = codes[-1].shape[1] * self.cfg.vq_strides[-1]
        return self.decoder(self.quantizer.from_codes(codes, out_len, level_mask))

    def roundtrip(self, wav: torch.Tensor) -> torch.Tensor:
        """encode -> quantize -> decode (the LALM attack inner op)."""
        z_q, _, _, _ = self.quantizer(self.encoder(wav))
        return self.decoder(z_q)

    @property
    def projected_codebook(self) -> torch.Tensor:
        """(K, codebook_dim) first-level codebook (the codec-latent
        watermarks' table)."""
        return self.quantizer.level_0.codebook

    def project_latent(self, z: torch.Tensor) -> torch.Tensor:
        """The first VQ level's input projection (latent -> codebook_dim)."""
        return self.quantizer.level_0.in_proj(z)
