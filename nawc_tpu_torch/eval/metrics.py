"""Audio-quality metrics (``nawc_tpu/eval/metrics.py``): SI-SNR, SNR,
log-spectral distance and the short-time intelligibility approximation,
batched on the device; PESQ-wb on the host (:func:`pesq_host`: the ITU
``pesq`` package when it imports, else the calibrated proxy of
``eval/pesq_proxy.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..dsp.stft import stft
from ..utils.config import StftConfig

_EPS = 1e-8


def si_snr(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Scale-invariant SNR in dB over the last axis; batched elsewhere."""
    ref = ref - ref.mean(dim=-1, keepdim=True)
    est = est - est.mean(dim=-1, keepdim=True)
    dot = (ref * est).sum(dim=-1, keepdim=True)
    energy = (ref * ref).sum(dim=-1, keepdim=True)
    proj = dot / (energy + _EPS) * ref
    noise = est - proj
    return 10.0 * torch.log10(((proj**2).sum(dim=-1) + _EPS) / ((noise**2).sum(dim=-1) + _EPS))


def snr(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """Classic SNR in dB of est against ref."""
    err = ref - est
    return 10.0 * torch.log10(((ref**2).sum(dim=-1) + _EPS) / ((err**2).sum(dim=-1) + _EPS))


def lsd(ref: torch.Tensor, est: torch.Tensor,
        cfg: StftConfig = StftConfig(2048, 512, 2048)) -> torch.Tensor:
    """Log-spectral distance (dB): the RMS over frequency of 20 log10 of the
    magnitude ratio, averaged over frames."""
    d = 20.0 * (torch.log10(stft(ref, cfg).abs() + _EPS) - torch.log10(stft(est, cfg).abs() + _EPS))
    return torch.sqrt((d * d).mean(dim=-1)).mean(dim=-1)


def _third_octave_matrix(sr: int, n_fft: int, n_bands: int = 15, f_start: float = 150.0) -> np.ndarray:
    """(n_bins, n_bands) rectangular 1/3-octave band matrix (STOI-style)."""
    freqs = np.linspace(0, sr / 2, n_fft // 2 + 1)
    mat = np.zeros((freqs.size, n_bands), np.float32)
    for k in range(n_bands):
        lo = f_start * 2 ** (k / 3.0)
        hi = f_start * 2 ** ((k + 1) / 3.0)
        mat[:, k] = ((freqs >= lo) & (freqs < hi)).astype(np.float32)
    return mat


def stoi(ref: torch.Tensor, est: torch.Tensor, sample_rate: int = 16_000) -> torch.Tensor:
    """Short-time objective intelligibility (an approximation): 1/3-octave
    band envelopes of 25 ms frames, correlated over 384 ms (30-frame)
    segments with clipped normalisation, averaged.  Tracks pystoi's ranking;
    not the published algorithm bit for bit."""
    n_fft = 512 if sample_rate <= 16_000 else 1024
    cfg = StftConfig(n_fft, n_fft // 2, n_fft)
    ob = torch.from_numpy(_third_octave_matrix(sample_rate, n_fft)).to(ref.device)
    xr = torch.sqrt((stft(ref, cfg).abs() ** 2) @ ob + _EPS)  # (..., T', bands)
    xe = torch.sqrt((stft(est, cfg).abs() ** 2) @ ob + _EPS)
    seg = 30
    n_seg = max(xr.shape[-2] - seg + 1, 1)
    idx = torch.arange(n_seg, device=ref.device)[:, None] + torch.arange(seg, device=ref.device)[None, :]
    rs = xr[..., idx, :]  # (..., n_seg, seg, bands)
    es = xe[..., idx, :]
    # normalise the estimate's segment energy to the reference's, clipped at
    # a +15 dB SDR floor
    scale = torch.sqrt((rs**2).sum(dim=-2, keepdim=True) / ((es**2).sum(dim=-2, keepdim=True) + _EPS))
    es = torch.minimum(es * scale, rs * (1 + 10 ** (-15.0 / 20.0)))
    rm = rs - rs.mean(dim=-2, keepdim=True)
    em = es - es.mean(dim=-2, keepdim=True)
    corr = (rm * em).sum(dim=-2) / (
        torch.linalg.vector_norm(rm, dim=-2) * torch.linalg.vector_norm(em, dim=-2) + _EPS)
    return corr.mean(dim=(-2, -1))


def pesq_host(ref: np.ndarray, est: np.ndarray, sample_rate: int) -> float:
    """PESQ-wb on the host.  Prefers the ITU `pesq` package (both signals
    resampled to 16 kHz wideband first: the package rejects other rates);
    when it does not import, the calibrated Bark-disturbance proxy
    (``eval/pesq_proxy.py``).  NaN when the measure fails.
    :func:`pesq_impl` says which one is active."""
    ref = np.asarray(ref, np.float64).reshape(-1)
    est = np.asarray(est, np.float64).reshape(-1)
    try:
        from pesq import pesq as _pesq  # type: ignore

        from .pesq_proxy import _to_16k

        try:
            return float(_pesq(16_000, _to_16k(ref, sample_rate), _to_16k(est, sample_rate), "wb"))
        except Exception:
            return float("nan")
    except ImportError:
        pass
    try:
        from .pesq_proxy import pesq_proxy

        return pesq_proxy(ref, est, sample_rate)
    except Exception:
        return float("nan")


def pesq_impl() -> str:
    """'itu' when the `pesq` package is importable, else 'proxy'."""
    try:
        import pesq  # type: ignore  # noqa: F401

        return "itu"
    except ImportError:
        return "proxy"


def si_sdr(ref: torch.Tensor, est: torch.Tensor) -> torch.Tensor:
    """The name the reference's LALM probe uses for :func:`si_snr`."""
    return si_snr(ref, est)
