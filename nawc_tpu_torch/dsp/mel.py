"""Mel filterbank (Slaney-style) and log-mel spectrograms
(``nawc_tpu/dsp/mel.py``).

The filterbank is built in float64 numpy and cached as float32 numpy, as
the JAX package builds it; it is applied as one matmul.  The codec and
watermark trainers' mel losses and ``cli/eval_codec.py`` use it.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..utils.config import MelConfig, StftConfig
from .stft import spectrogram


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (linear below 1 kHz, log above)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, f / f_sp)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


@functools.lru_cache(maxsize=32)
def _mel_matrix_np(cfg: MelConfig) -> np.ndarray:
    """(n_bins, n_mels) triangular filterbank with Slaney area normalization."""
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2
    n_bins = cfg.n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2, n_bins)
    mel_pts = np.linspace(hz_to_mel(cfg.fmin), hz_to_mel(fmax), cfg.n_mels + 2)
    hz_pts = mel_to_hz(mel_pts)
    fb = np.zeros((n_bins, cfg.n_mels))
    for i in range(cfg.n_mels):
        lo, ctr, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (fft_freqs - lo) / max(ctr - lo, 1e-10)
        down = (hi - fft_freqs) / max(hi - ctr, 1e-10)
        fb[:, i] = np.maximum(0.0, np.minimum(up, down))
        enorm = 2.0 / (hi - lo)
        fb[:, i] *= enorm
    return fb.astype(np.float32)


def mel_matrix(cfg: MelConfig, device: str | torch.device = "cpu") -> torch.Tensor:
    """(n_bins, n_mels) filterbank as a float32 tensor on `device`."""
    return torch.from_numpy(_mel_matrix_np(cfg)).to(device)


def mel_spectrogram(
    x: torch.Tensor,
    stft_cfg: StftConfig = StftConfig(),
    mel_cfg: MelConfig = MelConfig(),
    log: bool = True,
) -> torch.Tensor:
    """(..., T) -> (..., n_frames, n_mels) (log-)mel power spectrogram."""
    power = spectrogram(x, stft_cfg, power=2.0)
    mels = power @ mel_matrix(mel_cfg, x.device).to(power.dtype)
    if log:
        mels = torch.log(torch.clamp(mels, min=1e-5))
    return mels
