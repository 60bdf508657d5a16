"""PESQ proxy (``nawc_tpu/eval/pesq_proxy.py``): a Bark-spectral
loudness-disturbance model calibrated to ITU-T P.862 PESQ-wb on the
reference's 720 checked-in quality pairs.

When the ITU ``pesq`` package is absent, :func:`~nawc_tpu_torch.eval.metrics.pesq_host`
uses this model.  It is an original perceptual disturbance measure in the
spirit of P.862 -- Bark-band power, Zwicker-style loudness, a masking
dead-zone, an asymmetric penalty for additive distortion, split into low
and high Bark regions, two-stage Lp time aggregation -- whose three
disturbance features map to the PESQ-wb scale with coefficients fitted on
those 720 (audio pair, true PESQ) examples (``scripts/fit_pesq_proxy_audio.py``;
accuracy in ``docs/metrics.md``: leave-one-method-out MAE 0.28 worst-method
/ 0.13 mean, all-data MAE 0.10 on PESQ 2.67-4.63).  The proxy is NOT ITU
PESQ and is labelled as such wherever it is reported.

Scope: time-aligned pairs (watermark pairs are, by construction; no
alignment search), the 16 kHz wideband operating point (other rates are
resampled with scipy's ``resample_poly``, imported only then), clips of
at least about 0.25 s.
"""

from __future__ import annotations

import functools

import numpy as np

_SR = 16_000
_NFFT = 512
_HOP = 256
_NBANDS = 42
_SPLIT = 26  # low/high Bark split (~2.3 kHz): disturbance is weighed
# differently around the formant region, mirroring P.862's band emphasis
_LEVEL = 1000.0  # RMS working level both signals are aligned to
_POW = 0.15  # loudness compression exponent
_MASK = 0.5  # masking dead-zone fraction of min loudness
_ADD = 50.0  # asymmetry-ratio additive floor (at the working level)
_ASYM_LO, _ASYM_HI = 1.5, 12.0
_GAIN_CLIP = 10.0  # per-band linear-filtering forgiveness
_CHUNK, _P = 20, 2.0  # two-stage time aggregation
_EPS = 1e-12

# log1p(100 * [d_sym_lo, d_sym_hi, d_asym]) -> MOS-LQO-wb, least squares on
# the 720 reference pairs (scripts/fit_pesq_proxy_audio.py)
_COEF = np.array([4.61421652, 0.26231516, -0.23727196, -0.32631891])
_CLIP = (1.02, 4.64)


@functools.lru_cache(maxsize=4)
def _bark_matrix(sr: int = _SR, n_fft: int = _NFFT, n_bands: int = _NBANDS):
    """(n_bands, n_bins) averaging matrix over Bark-spaced bands."""
    f = np.linspace(0.0, sr / 2.0, n_fft // 2 + 1)
    z = 13.0 * np.arctan(0.00076 * f) + 3.5 * np.arctan((f / 7500.0) ** 2)
    edges = np.linspace(0.0, z[-1] + 1e-6, n_bands + 1)
    band = np.clip(np.digitize(z, edges) - 1, 0, n_bands - 1)
    w = np.zeros((n_bands, f.size), np.float64)
    w[band, np.arange(f.size)] = 1.0
    counts = w.sum(axis=1, keepdims=True)
    return w / np.maximum(counts, 1.0)


def _to_16k(x: np.ndarray, sr: int) -> np.ndarray:
    x = np.asarray(x, np.float64).reshape(-1)
    if sr == _SR:
        return x
    from scipy.signal import resample_poly

    g = np.gcd(int(sr), _SR)
    return resample_poly(x, _SR // g, sr // g)


def _frames_power(x: np.ndarray) -> np.ndarray:
    """(T, n_bins) Hann-windowed power spectra."""
    n = (len(x) - _NFFT) // _HOP + 1
    if n < 1:
        raise ValueError("clip too short for the PESQ proxy")
    idx = np.arange(_NFFT)[None, :] + _HOP * np.arange(n)[:, None]
    fr = x[idx] * np.hanning(_NFFT)[None, :]
    spec = np.fft.rfft(fr, axis=-1)
    return (spec.real**2 + spec.imag**2) / _NFFT


def _two_stage(v: np.ndarray) -> float:
    """Lp over CHUNK-frame spans, then L2 over spans (P.862-style split)."""
    pad = (-len(v)) % _CHUNK
    v = np.pad(v, (0, pad))
    c = np.power(np.mean(np.power(v.reshape(-1, _CHUNK), _P), axis=1), 1.0 / _P)
    return float(np.sqrt(np.mean(c**2)))


def bark_disturbance(
    ref: np.ndarray, deg: np.ndarray, sample_rate: int
) -> tuple[float, float, float]:
    """(d_sym_low, d_sym_high, d_asym) perceptual disturbance features.
    Higher = more audible degradation."""
    r = _to_16k(ref, sample_rate)
    d = _to_16k(deg, sample_rate)
    n = min(len(r), len(d))
    r, d = r[:n], d[:n]
    # level alignment: each signal to the fixed RMS working level
    r = r * (_LEVEL / (np.sqrt(np.mean(r**2)) + _EPS))
    d = d * (_LEVEL / (np.sqrt(np.mean(d**2)) + _EPS))

    w = _bark_matrix()
    pr = _frames_power(r) @ w.T  # (T, n_bands)
    pd = _frames_power(d) @ w.T
    energy = pr.sum(axis=1)
    active = energy > 1e-2 * np.mean(energy)
    if active.sum() < 4:
        active = np.ones_like(active)

    # per-band gain compensation: forgive mild linear filtering (PESQ-style)
    g = (pr[active].mean(axis=0) + 1e-6) / (pd[active].mean(axis=0) + 1e-6)
    pd = pd * np.clip(g, 1.0 / _GAIN_CLIP, _GAIN_CLIP)[None, :]

    lr = np.power(pr + _EPS, _POW)
    ld = np.power(pd + _EPS, _POW)
    dsym = np.maximum(np.abs(ld - lr) - _MASK * np.minimum(lr, ld), 0.0)

    ratio = np.power((pd + _ADD) / (pr + _ADD), 1.2)
    asym = np.where(ratio < _ASYM_LO, 0.0, np.minimum(ratio, _ASYM_HI))
    dasym = dsym * asym

    fs_lo = np.sqrt(np.mean(dsym[active][:, :_SPLIT] ** 2, axis=1))
    fs_hi = np.sqrt(np.mean(dsym[active][:, _SPLIT:] ** 2, axis=1))
    fa = np.mean(dasym[active], axis=1)
    return _two_stage(fs_lo), _two_stage(fs_hi), _two_stage(fa)


def pesq_proxy(ref: np.ndarray, deg: np.ndarray, sample_rate: int) -> float:
    """PESQ-wb proxy MOS in [1.02, 4.64].  NOT ITU PESQ — a calibrated
    Bark-disturbance model (see module docstring and docs/metrics.md)."""
    feats = np.asarray(bark_disturbance(ref, deg, sample_rate))
    x = np.concatenate([[1.0], np.log1p(100.0 * feats)])
    return float(np.clip(x @ _COEF, *_CLIP))
