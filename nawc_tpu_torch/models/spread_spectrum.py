"""Designed (training-free) spread-spectrum watermark
(``nawc_tpu/models/spread_spectrum.py``): a 16-bit payload as pseudo-noise
log-magnitude modulation of an STFT band, read back by a self-calibrated
matched filter.  See the JAX module's docstring for the scheme.

The PN patterns come from :mod:`..utils.jaxrand`, bit-identical to
``jax.random``, so a mark made by either package is read by the other.
The whiten+correlate pass of detect runs the CUDA kernel of ``ops/sswm.py``
on the card.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.stft import istft, stft
from ..ops.sswm import whiten_correlate
from ..utils import jaxrand, profiling
from ..utils.config import SpreadSpectrumConfig, StftConfig
from .base import register

_PN_PERIOD = 64  # frames per PN tile
_TIME_CELL = 4  # frames per PN chip
_FREQ_CELL = 4  # bins per PN chip
_NULL_OFFSETS = (17, 23, 29, 37, 47, 53)  # frame rolls for null calibration


def _band_slice(cfg: SpreadSpectrumConfig) -> tuple[int, int]:
    n_bins = cfg.n_fft // 2 + 1
    lo = int(round(cfg.band_lo_hz / (cfg.sample_rate / 2) * (n_bins - 1)))
    hi = int(round(cfg.band_hi_hz / (cfg.sample_rate / 2) * (n_bins - 1)))
    return lo, max(hi, lo + 8)


@functools.lru_cache(maxsize=32)
def _pn_patterns_np(seed: int, cfg: SpreadSpectrumConfig) -> np.ndarray:
    """(n_bits, P, band_width) +-1 float32 patterns, piecewise-constant over
    (_TIME_CELL x _FREQ_CELL) cells; bit b's cells are
    ``bernoulli(fold_in(PRNGKey(seed), b), 0.5, (tc, fc))``."""
    lo, hi = _band_slice(cfg)
    width = hi - lo
    tc = _PN_PERIOD // _TIME_CELL
    fc = -(-width // _FREQ_CELL)
    key = jaxrand.prng_key(seed)
    bits = np.stack([jaxrand.bernoulli(jaxrand.fold_in(key, b), 0.5, (tc, fc))
                     for b in range(cfg.n_bits)])
    p = 2.0 * bits.astype(np.float32) - 1.0
    p = np.repeat(np.repeat(p, _TIME_CELL, axis=1), _FREQ_CELL, axis=2)
    p = np.ascontiguousarray(p[:, :, :width])
    p.setflags(write=False)
    return p


def _tile_patterns(p: torch.Tensor, t: int) -> torch.Tensor:
    """(n_bits, P, W) -> (n_bits, t, W) by tiling the period along time."""
    reps = -(-t // _PN_PERIOD)
    return p.repeat(1, reps, 1)[:, :t]


def _quantiles(x: torch.Tensor, qs: tuple[float, ...]) -> list[torch.Tensor]:
    """``jnp.quantile(x, q, axis=-1)`` for each q: one sort, then its default
    linear interpolation with its float32 position and weights, so any row
    length works (``torch.quantile`` refuses rows over 2^24 elements).  A
    row that holds a NaN gives NaN, as in ``jnp.quantile``."""
    srt = torch.sort(x, dim=-1).values
    n1 = np.float32(x.shape[-1]) - np.float32(1)
    has_nan = torch.isnan(srt[..., -1])  # NaNs sort last
    out = []
    for q in qs:
        pos = np.float32(q) * n1
        lo, hi = np.clip(np.floor(pos), 0, n1), np.clip(np.ceil(pos), 0, n1)
        w_hi = pos - np.floor(pos)
        v = srt[..., int(lo)] * float(np.float32(1) - w_hi) + srt[..., int(hi)] * float(w_hi)
        out.append(torch.where(has_nan, torch.nan, v))
    return out


def _level_mask(band_logmag: torch.Tensor, cfg: SpreadSpectrumConfig) -> torch.Tensor:
    """(..., T, W) band log-magnitude -> soft mask in (0, 1] sparing the
    loudest bins; the per-clip quantiles are ``jnp.quantile``'s."""
    if cfg.mask_quantile <= 0.0 and cfg.mask_lo_quantile <= 0.0:
        return torch.ones_like(band_logmag)
    flat = band_logmag.reshape(band_logmag.shape[:-2] + (-1,))
    qs = tuple(q for q in (cfg.mask_quantile, cfg.mask_lo_quantile) if q > 0.0)
    taus = [tau[..., None, None] for tau in _quantiles(flat, qs)]
    w = torch.ones_like(band_logmag)
    if cfg.mask_quantile > 0.0:
        w = w * torch.sigmoid((taus[0] - band_logmag) / cfg.mask_softness)
    if cfg.mask_lo_quantile > 0.0:
        w = w * torch.sigmoid((band_logmag - taus[-1]) / cfg.mask_softness)
    return w


def _freq_smooth(logmag: torch.Tensor, width: int = 15) -> torch.Tensor:
    """Moving average over the frequency axis (spectral envelope estimate);
    flax's "edge" padding is PyTorch's "replicate"."""
    pad = width // 2
    lead = logmag.shape[:-1]
    x = F.pad(logmag.reshape(-1, 1, logmag.shape[-1]), (pad, pad), mode="replicate")
    kernel = torch.ones((1, 1, width), device=logmag.device, dtype=logmag.dtype) / width
    out = F.conv1d(x, kernel)
    return out.reshape(lead + (out.shape[-1],))


@dataclasses.dataclass(frozen=True)
class SpreadSpectrumWM:
    """See module docstring.  `seed` fixes the secret key.  The defaults are
    the JAX package's (alpha 0.18, the loudest 15% of band bins spared)."""

    cfg: SpreadSpectrumConfig = SpreadSpectrumConfig(alpha=0.18, mask_quantile=0.85)
    seed: int = 0
    n_passes: int = 2
    name: str = "spread_spectrum"
    presence_z0: float = 1.3
    presence_gain: float = 4.0
    score_z0: float = 0.8
    score_gain: float = 3.0

    @property
    def sample_rate(self) -> int:
        return self.cfg.sample_rate

    @property
    def n_bits(self) -> int:
        return self.cfg.n_bits

    @property
    def stft_cfg(self) -> StftConfig:
        return StftConfig(self.cfg.n_fft, self.cfg.hop, self.cfg.n_fft)

    def _patterns(self, device: torch.device) -> torch.Tensor:
        return profiling.to_device(_pn_patterns_np(self.seed, self.cfg), device)

    # -- embed -------------------------------------------------------------
    def embed(self, wav: torch.Tensor, msg: torch.Tensor, key=None) -> torch.Tensor:
        """(B, T), (B, n_bits) in {0, 1} -> (B, T) marked audio.  `key` is
        unused (the secret is `seed`), as in the JAX package."""
        with profiling.annotate("ss.embed", wav.device):
            cfg = self.cfg
            lo, hi = _band_slice(cfg)
            spec_clean = stft(wav, self.stft_cfg)  # (B, T', F)
            t = spec_clean.shape[-2]
            p = _tile_patterns(self._patterns(wav.device), t)  # (n_bits, T', W)
            s = 2.0 * msg.to(torch.float32) - 1.0  # (B, n_bits)
            mod = torch.einsum("bk,ktw->btw", s, p) / math.sqrt(float(cfg.n_bits))
            want = cfg.alpha * torch.clamp(mod, -3.0, 3.0)  # target log-mag delta
            log_clean = torch.log(torch.abs(spec_clean) + 1e-6)
            want = want * _level_mask(log_clean[..., lo:hi], cfg)

            gain = torch.ones_like(spec_clean.real)
            gain[..., lo:hi] += want
            marked = istft(spec_clean * gain, self.stft_cfg, length=wav.shape[-1])
            for _ in range(self.n_passes - 1):
                # re-apply the modulation the overlap-add resynthesis lost
                sm = stft(marked, self.stft_cfg)
                delta = torch.log(torch.abs(sm) + 1e-6) - log_clean
                fix = torch.clamp(want - delta[..., lo:hi], -0.5, 0.5)
                gain = torch.ones_like(sm.real)
                gain[..., lo:hi] += fix
                marked = istft(sm * gain, self.stft_cfg, length=wav.shape[-1])
            return torch.clamp(marked, -1.0, 1.0)

    # -- detect ------------------------------------------------------------
    def _band_residual(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, T', W) band log-magnitude minus its spectral
        envelope, down-weighted where the embed spared the loudest bins."""
        lo, hi = _band_slice(self.cfg)
        logmag = torch.log(torch.abs(stft(wav, self.stft_cfg)) + 1e-6)
        r = (logmag - _freq_smooth(logmag))[..., lo:hi]
        return r * _level_mask(logmag[..., lo:hi], self.cfg)

    def _correlate(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, n_bits) self-calibrated statistics z_b
        (~N(0,1) on unmarked audio)."""
        r = self._band_residual(wav)  # (B, T', W)
        p = _tile_patterns(self._patterns(wav.device), r.shape[-2])  # (n_bits, T', W)
        return whiten_correlate(r, p, _NULL_OFFSETS)

    def _presence(self, z: torch.Tensor) -> torch.Tensor:
        return torch.sigmoid(self.presence_gain * (z.abs().mean(dim=-1) - self.presence_z0))

    def detect(self, wav: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        with profiling.annotate("ss.detect", wav.device):
            z = self._correlate(wav)
            return self._presence(z), (z > 0).to(torch.int32)

    # -- synchronization search -------------------------------------------
    def _whitened_residual(self, wav: torch.Tensor) -> torch.Tensor:
        r = self._band_residual(wav)
        mu = r.mean(dim=-2, keepdim=True)
        sd = r.std(dim=-2, keepdim=True, correction=0)  # jnp.std is the population std
        r = (r - mu) / (sd + 0.2)
        return r - r.mean(dim=(-2, -1), keepdim=True)

    def _correlate_all_lags(self, wav: torch.Tensor) -> torch.Tensor:
        """(B, T) -> (B, n_bits, L) correlation statistics at every cyclic
        frame lag, by FFT cross-correlation along time; sigma per clip is
        1.4826 times the median |c| over bits and lags (``jnp.median``
        averages the two middle values, as ``_quantiles`` does at 0.5)."""
        r = self._whitened_residual(wav)  # (B, T', W)
        t = r.shape[-2]
        p = _tile_patterns(self._patterns(wav.device), t)  # (K, T', W)
        p = p - p.mean(dim=-2, keepdim=True)
        rf = torch.fft.rfft(r, dim=-2)  # (B, F, W)
        pf = torch.fft.rfft(p, dim=-2)  # (K, F, W)
        cross = torch.einsum("bfw,kfw->bkf", rf, torch.conj(pf))
        c = torch.fft.irfft(cross, n=t, dim=-1)  # (B, K, L)
        med = _quantiles(c.abs().reshape(c.shape[0], -1), (0.5,))[0]
        sigma = 1.4826 * med[:, None, None]
        return c / (sigma + 1e-8)

    def detect_sync(
        self, wav: torch.Tensor, max_lag: int | None = None
    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Shift-robust detection: search frame lags, decode at the best.
        -> (presence, bits, best_lag_frames).  `max_lag` restricts the
        search window (None = all cyclic lags); the presence gate sits higher
        than plain detect's, since the max over L lags is inflated under H0."""
        z = self._correlate_all_lags(wav)  # (B, K, L)
        if max_lag is not None:
            z = z[..., : max_lag + 1]
        strength = z.abs().mean(dim=-2)  # (B, L)
        best = torch.argmax(strength, dim=-1)  # (B,), the first on ties
        z_best = torch.gather(z, -1, best[:, None, None].expand(-1, z.shape[1], 1))[..., 0]
        bits = (z_best > 0).to(torch.int32)
        lags = np.float32(max(z.shape[-1], 2))
        z0 = self.presence_z0 + np.float32(0.1) * np.sqrt(np.float32(2.0) * np.log(lags))
        presence = torch.sigmoid(6.0 * (z_best.abs().mean(dim=-1) - float(z0)))
        return presence, bits, best

    def score(self, wav: torch.Tensor, msg: torch.Tensor | None = None) -> torch.Tensor:
        """Presence probability; with a known payload, the signed correlation."""
        with profiling.annotate("ss.detect", wav.device):
            z = self._correlate(wav)
            if msg is None:
                return self._presence(z)
            s = 2.0 * msg.to(torch.float32) - 1.0
            return torch.sigmoid(self.score_gain * ((z * s).mean(dim=-1) - self.score_z0))


@register("spread_spectrum")
def _build(cfg: SpreadSpectrumConfig | None = None, seed: int = 0) -> SpreadSpectrumWM:
    return SpreadSpectrumWM(cfg=cfg, seed=seed) if cfg is not None else SpreadSpectrumWM(seed=seed)
