"""Spectral footprint of watermark residuals (``nawc_tpu/interp/spectral.py``):
residual wm - clean -> per-clip SNR and the mean energy per frequency band
of its power spectrogram (n_fft 2048)."""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.stft import spectrogram
from ..utils.config import StftConfig

_CFG = StftConfig(2048, 512, 2048)


def band_energies(residual: torch.Tensor, n_bands: int = 8) -> torch.Tensor:
    """(B, T) residual -> (B, n_bands) mean energy per frequency band; the
    top ``F % n_bands`` bins are left out, as in the JAX package."""
    spec = spectrogram(residual, _CFG, power=2.0)  # (B, T', F)
    width = spec.shape[-1] // n_bands
    bands = spec[..., : width * n_bands].reshape(spec.shape[:-1] + (n_bands, width))
    return bands.mean(dim=(-3, -1))


def residual_report(clean: torch.Tensor, marked: torch.Tensor, n_bands: int = 8) -> dict[str, np.ndarray]:
    """Per-clip SNR of the watermark residual and its band-energy profile."""
    residual = marked - clean
    p_sig = (clean**2).sum(dim=-1)
    p_res = (residual**2).sum(dim=-1)
    snr = 10.0 * torch.log10((p_sig + 1e-10) / (p_res + 1e-10))
    return {
        "snr_db": snr.cpu().numpy(),
        "band_energy": band_energies(residual, n_bands).cpu().numpy(),
    }
