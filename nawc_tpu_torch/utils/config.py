"""Configuration dataclasses, field for field as in
``nawc_tpu/utils/config.py`` with the same defaults.

Only the configs of the families the port has are here.  The JAX
package's ``compute_jnp_dtype`` becomes :attr:`CodecConfig.compute_torch_dtype`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """Framed STFT/iSTFT parameters (centered, Hann-windowed)."""

    n_fft: int = 1024
    hop: int = 256
    win: int = 1024

    @property
    def n_bins(self) -> int:
        return self.n_fft // 2 + 1


@dataclasses.dataclass(frozen=True)
class MelConfig:
    """Mel filterbank parameters (Slaney-style, area-normalized)."""

    sample_rate: int = 24_000
    n_fft: int = 1024
    n_mels: int = 80
    fmin: float = 0.0
    fmax: float | None = None


@dataclasses.dataclass(frozen=True)
class CodecConfig:
    """SNAC-style codec (conv encoder -> multi-scale RVQ -> conv decoder)."""

    sample_rate: int = 24_000
    # conv compute dtype ("bfloat16" | "float32")
    compute_dtype: str = "float32"
    encoder_dim: int = 48
    encoder_rates: Tuple[int, ...] = (2, 4, 8, 8)
    latent_dim: int = 768
    decoder_dim: int = 768
    decoder_rates: Tuple[int, ...] = (8, 8, 4, 2)
    codebook_size: int = 4096
    codebook_dim: int = 8
    vq_strides: Tuple[int, ...] = (4, 2, 1)
    noise_decoder: bool = True  # read by no code of either package (kept for field parity)
    # SNAC's own layout ("snac"; the repo's is "nawc"): the encoder ends in windowed attention
    # and a k7 conv (no Snake, no k3 conv), the decoder starts with a k7 and a k1 conv and
    # windowed attention, strided and transposed convs pad ceil(s / 2) on both sides, and
    # clips pad to hop * lcm(vq_strides[0], attn_window)
    layout: str = "nawc"
    depthwise: bool = False  # SNAC's depthwise-separable residual units (groups = channels)
    attn_window: int = 0  # LocalMHA's window in frames; 0: no attention ("snac" layout only)
    noise_blocks: bool = False  # SNAC's NoiseBlock after each decoder upsampling
    # Mimi's layout ("mimi", ``codec/mimi.py``): a causal SEANet with ELU (encoder_dim its
    # num_filters, latent_dim its hidden size, decoder_dim its widest channels), a transformer
    # of `tfm_layers` pre-norm layers (`tfm_heads` heads of latent_dim / tfm_heads, an MLP of
    # `tfm_ffn`, RoPE, a causal window of `tfm_context` frames) after the encoder and before
    # the decoder, a learnt resampler by `resample_stride`, and a split RVQ: `semantic_levels`
    # levels and the acoustic ones, all fed the latent, every level Euclidean at stride 1;
    # `n_q` of the len(vq_strides) levels held are used (0: all)
    tfm_layers: int = 0
    tfm_heads: int = 0
    tfm_ffn: int = 0
    tfm_context: int = 0
    resample_stride: int = 1
    semantic_levels: int = 0
    n_q: int = 0

    def __post_init__(self):
        if self.layout not in ("nawc", "snac", "mimi"):
            raise ValueError(f"CodecConfig: layout {self.layout!r} is none of 'nawc', 'snac', 'mimi'")
        if self.layout != "snac" and self.attn_window:
            raise ValueError("CodecConfig: windowed attention runs in the 'snac' layout only")
        if self.layout == "snac" and self.latent_dim != self.encoder_dim * 2 ** len(self.encoder_rates):
            raise ValueError(f"CodecConfig: SNAC's latent_dim is encoder_dim * 2^{len(self.encoder_rates)}"
                             f" = {self.encoder_dim * 2 ** len(self.encoder_rates)}, got {self.latent_dim}")
        mimi = (self.tfm_layers, self.tfm_heads, self.tfm_ffn, self.tfm_context, self.resample_stride - 1,
                self.semantic_levels)
        if self.layout != "mimi" and any(mimi):
            raise ValueError("CodecConfig: the transformers, resampler and split RVQ are the 'mimi' layout's")
        if self.layout == "mimi":
            widest = self.encoder_dim * 2 ** len(self.encoder_rates)
            if self.decoder_dim != widest or tuple(self.decoder_rates) != tuple(self.encoder_rates[::-1]):
                raise ValueError(f"CodecConfig: Mimi's decoder mirrors its encoder: decoder_dim {widest}, "
                                 f"decoder_rates {tuple(self.encoder_rates[::-1])}")
            if not self.tfm_heads or self.latent_dim % self.tfm_heads:
                raise ValueError(f"CodecConfig: {self.latent_dim} channels are not {self.tfm_heads} heads")
            if set(self.vq_strides) != {1} or not 0 < self.semantic_levels < len(self.vq_strides):
                raise ValueError("CodecConfig: Mimi's levels run at stride 1, a semantic one first")
        if not self.semantic_levels <= self.n_q <= len(self.vq_strides) and self.n_q:
            raise ValueError(f"CodecConfig: n_q {self.n_q} outside [{self.semantic_levels}, "
                             f"{len(self.vq_strides)}]")

    @classmethod
    def snac_44khz(cls, **overrides) -> "CodecConfig":
        """hubertsiuzdak/snac_44khz's published config (its ``config.json``):
        54.5 M parameters, 2.6 kbps."""
        return cls(**{**dict(
            sample_rate=44_100, encoder_dim=64, encoder_rates=(2, 3, 8, 8), latent_dim=1024,
            decoder_dim=1536, decoder_rates=(8, 8, 3, 2), codebook_size=4096, codebook_dim=8,
            vq_strides=(8, 4, 2, 1), layout="snac", depthwise=True, attn_window=32,
            noise_blocks=True), **overrides})

    @classmethod
    def mimi(cls, **overrides) -> "CodecConfig":
        """kyutai/mimi's published config (its ``config.json``; the speech
        tokenizer of Moshi): 24 kHz, a 25 Hz SEANet resampled to 12.5 Hz,
        two 8-layer transformers, 32 codebooks of 2048 x 256 held (one
        semantic), 8 used as Moshi decodes them; 96,085,825 parameters."""
        return cls(**{**dict(
            sample_rate=24_000, encoder_dim=64, encoder_rates=(4, 5, 6, 8), latent_dim=512,
            decoder_dim=1024, decoder_rates=(8, 6, 5, 4), codebook_size=2048, codebook_dim=256,
            vq_strides=(1,) * 32, layout="mimi", tfm_layers=8, tfm_heads=8, tfm_ffn=2048,
            tfm_context=250, resample_stride=2, semantic_levels=1, n_q=8), **overrides})

    @property
    def compute_torch_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.compute_dtype == "bfloat16" else torch.float32

    @property
    def hop(self) -> int:
        """Samples per latent frame (product of encoder strides)."""
        h = 1
        for r in self.encoder_rates:
            h *= r
        return h

    @property
    def chunk(self) -> int:
        """Pad-to multiple in samples: ``hop * max(vq_strides)``, with the
        reference's 4096 as a floor; in the "snac" layout SNAC's
        ``preprocess`` rule, ``hop * lcm(vq_strides[0], attn_window)``; in
        the "mimi" layout one frame, ``hop * resample_stride``."""
        if self.layout == "snac":
            return self.hop * math.lcm(self.vq_strides[0], self.attn_window or 1)
        if self.layout == "mimi":
            return self.hop * self.resample_stride
        return max(4096, self.hop * max(self.vq_strides))

    @property
    def num_levels(self) -> int:
        """The levels the codec uses: ``n_q`` where set, else all held."""
        return self.n_q or len(self.vq_strides)


@dataclasses.dataclass(frozen=True)
class SpreadSpectrumConfig:
    """Designed (training-free) spread-spectrum watermark; see
    ``nawc_tpu/utils/config.py`` for the reasoning behind each field."""

    sample_rate: int = 16_000
    n_bits: int = 16
    n_fft: int = 1024
    hop: int = 256
    band_lo_hz: float = 400.0
    band_hi_hz: float = 6_000.0
    alpha: float = 0.06  # embedding strength relative to band magnitude
    mask_quantile: float = 0.0
    mask_lo_quantile: float = 0.0
    mask_softness: float = 1.0


@dataclasses.dataclass(frozen=True)
class NeuralWMConfig:
    """Trainable AudioSeal-style additive generator + frame-wise detector;
    see ``nawc_tpu/utils/config.py`` for the reasoning behind each field.

    ``window`` must equal the checkpoint's training crop: the message
    pattern is anchored to the generator's stride lattice (320 samples), so
    embed and detect both cut the stream into windows of this length."""

    sample_rate: int = 16_000
    n_bits: int = 16
    dim: int = 32
    strides: Tuple[int, ...] = (2, 4, 5, 8)
    bottleneck_dim: int = 128
    alpha: float = 1.0
    window: int = 16_000


@dataclasses.dataclass(frozen=True)
class SemanticWMConfig:
    """Semantic manifold watermark hyperparameters; see
    ``nawc_tpu/utils/config.py`` for the reasoning behind each field.

    ``max_steps_per_dispatch`` is kept for field parity and read by
    nothing: it bounds one XLA dispatch on the TPU, and the port's Adam
    loop has no dispatch to bound."""

    steps: int = 150
    lr: float = 5e-3
    eps: float = 5e-3
    dynamic_eps: bool = False
    target_sdr_db: float = 42.0
    eps_min: float = 1e-4
    eps_max: float = 0.1
    target_score: float = 1.5
    silence_threshold: float = 0.02
    detect_threshold: float = 0.85
    pn_seed: int = 7
    ma_window: int = 9
    score_scale: float = 0.28
    cap_mult: float = 6.0
    # > 0 enables the gradient-free spectral projection between phases
    lsd_weight: float = 0.0
    proj_headroom_db: float = 14.0
    n_proj_phases: int = 4
    proj_free_above_hz: float = 8000.0
    proj_stoi_extra_db: float = 0.0
    proj_stoi_hz: float = 4500.0
    max_steps_per_dispatch: int = 75
