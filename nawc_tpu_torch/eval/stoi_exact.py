"""Exact STOI on the host in numpy float64 (``nawc_tpu/eval/stoi_exact.py``):
the published Taal et al. 2010 algorithm as ``pystoi`` implements it.

The on-device :func:`nawc_tpu_torch.eval.metrics.stoi` is a fast batched
approximation (no silent-frame removal, no 10 kHz resample); this module is
the measurement of the reported quality tables, comparable with pystoi's
values.  Algorithm steps:

  1. resample both signals to 10 kHz (scipy ``resample_poly``, as pystoi),
  2. remove frames whose CLEAN-signal energy is >40 dB below the loudest
     frame (256-sample Hann frames, hop 128), overlap-adding the survivors,
  3. STFT (256-frame / 128-hop Hann, 512-point FFT),
  4. 15 one-third-octave bands from 150 Hz (edges cf*2^(+-1/6)),
  5. sliding 30-frame segments: per band, scale est to ref energy, clip at
     the -15 dB SDR bound, correlate zero-meaned envelopes,
  6. average correlations over bands and segments.

scipy is imported only where a signal is resampled.
"""

from __future__ import annotations

import numpy as np

FS = 10_000  # STOI operates at 10 kHz
N_FRAME = 256
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
N_SEG = 30  # 384 ms at 10 kHz / 128 hop
BETA_DB = -15.0
DYN_RANGE_DB = 40.0
_EPS = np.finfo(np.float64).eps


def _resample_10k(x: np.ndarray, sr: int) -> np.ndarray:
    if sr == FS:
        return x.astype(np.float64)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(int(sr), FS)
    return resample_poly(x.astype(np.float64), FS // g, sr // g)


def _frames(x: np.ndarray, win: np.ndarray) -> np.ndarray:
    n = (len(x) - N_FRAME) // HOP + 1
    if n <= 0:
        return np.zeros((0, N_FRAME))
    idx = np.arange(n)[:, None] * HOP + np.arange(N_FRAME)[None, :]
    return x[idx] * win[None, :]


def _remove_silent_frames(x: np.ndarray, y: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop frames whose clean-signal energy is > DYN_RANGE below the max,
    overlap-adding the kept frames (pystoi ``remove_silent_frames``)."""
    win = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(x, win)
    yf = _frames(y, win)
    if len(xf) == 0:
        return x, y
    energy = 20.0 * np.log10(np.linalg.norm(xf, axis=1) + _EPS)
    keep = energy > (energy.max() - DYN_RANGE_DB)
    xf, yf = xf[keep], yf[keep]
    if len(xf) == 0:
        return x, y
    n_out = (len(xf) - 1) * HOP + N_FRAME
    xs = np.zeros(n_out)
    ys = np.zeros(n_out)
    for i in range(len(xf)):  # OLA (hop = win/2, Hann -> unity)
        s = i * HOP
        xs[s : s + N_FRAME] += xf[i]
        ys[s : s + N_FRAME] += yf[i]
    return xs, ys


def _third_octave_bands() -> np.ndarray:
    """(n_bins, NUM_BANDS) rectangular band matrix with 2^(+-1/6) edges."""
    n_bins = NFFT // 2 + 1
    freqs = np.linspace(0, FS / 2, n_bins)
    cf = MIN_FREQ * 2.0 ** (np.arange(NUM_BANDS) / 3.0)
    lo = cf * 2.0 ** (-1.0 / 6.0)
    hi = cf * 2.0 ** (1.0 / 6.0)
    return ((freqs[:, None] >= lo[None, :]) & (freqs[:, None] < hi[None, :])).astype(np.float64)


def stoi_exact(ref: np.ndarray, est: np.ndarray, sr: int) -> float:
    """Exact (pystoi-algorithm) STOI of `est` against clean `ref`."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    t = min(len(ref), len(est))
    ref, est = ref[:t], est[:t]
    ref = _resample_10k(ref, sr)
    est = _resample_10k(est, sr)
    ref, est = _remove_silent_frames(ref, est)

    win = np.hanning(N_FRAME + 2)[1:-1]
    xf = _frames(ref, win)
    yf = _frames(est, win)
    if len(xf) < N_SEG:
        return float("nan")
    xs = np.abs(np.fft.rfft(xf, NFFT, axis=1))  # (T, n_bins)
    ys = np.abs(np.fft.rfft(yf, NFFT, axis=1))
    ob = _third_octave_bands()
    xb = np.sqrt((xs**2) @ ob + _EPS)  # (T, B)
    yb = np.sqrt((ys**2) @ ob + _EPS)

    n_seg = len(xb) - N_SEG + 1
    beta = 10.0 ** (BETA_DB / 20.0)
    total = 0.0
    for m in range(n_seg):
        rs = xb[m : m + N_SEG]  # (N, B)
        es = yb[m : m + N_SEG]
        alpha = np.sqrt((rs**2).sum(axis=0) / ((es**2).sum(axis=0) + _EPS))
        es = np.minimum(es * alpha[None, :], rs * (1.0 + beta))
        rm = rs - rs.mean(axis=0, keepdims=True)
        em = es - es.mean(axis=0, keepdims=True)
        corr = (rm * em).sum(axis=0) / (
            np.linalg.norm(rm, axis=0) * np.linalg.norm(em, axis=0) + _EPS
        )
        total += corr.sum()
    return float(total / (n_seg * NUM_BANDS))


def stoi_exact_batch(ref, est, sr: int) -> np.ndarray:
    """(B, T) x2 -> (B,) exact STOI per pair (host loop; quality tables are
    a few hundred pairs, negligible next to the embeds)."""
    ref = np.asarray(ref)
    est = np.asarray(est)
    return np.array([stoi_exact(ref[i], est[i], sr) for i in range(ref.shape[0])])
