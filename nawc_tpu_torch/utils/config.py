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

    def __post_init__(self):
        if self.layout not in ("nawc", "snac"):
            raise ValueError(f"CodecConfig: layout {self.layout!r} is neither 'nawc' nor 'snac'")
        if self.layout == "nawc" and self.attn_window:
            raise ValueError("CodecConfig: attention runs in the 'snac' layout only")
        if self.layout == "snac" and self.latent_dim != self.encoder_dim * 2 ** len(self.encoder_rates):
            raise ValueError(f"CodecConfig: SNAC's latent_dim is encoder_dim * 2^{len(self.encoder_rates)}"
                             f" = {self.encoder_dim * 2 ** len(self.encoder_rates)}, got {self.latent_dim}")

    @classmethod
    def snac_44khz(cls, **overrides) -> "CodecConfig":
        """hubertsiuzdak/snac_44khz's published config (its ``config.json``):
        54.5 M parameters, 2.6 kbps."""
        return cls(**{**dict(
            sample_rate=44_100, encoder_dim=64, encoder_rates=(2, 3, 8, 8), latent_dim=1024,
            decoder_dim=1536, decoder_rates=(8, 8, 3, 2), codebook_size=4096, codebook_dim=8,
            vq_strides=(8, 4, 2, 1), layout="snac", depthwise=True, attn_window=32,
            noise_blocks=True), **overrides})

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
        ``preprocess`` rule, ``hop * lcm(vq_strides[0], attn_window)``."""
        if self.layout == "snac":
            return self.hop * math.lcm(self.vq_strides[0], self.attn_window or 1)
        return max(4096, self.hop * max(self.vq_strides))

    @property
    def num_levels(self) -> int:
        return len(self.vq_strides)


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
