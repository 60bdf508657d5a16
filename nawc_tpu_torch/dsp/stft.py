"""Framed STFT / iSTFT with Hann windows and exact COLA overlap-add
(``nawc_tpu/dsp/stft.py``).

Not ``torch.stft``: the JAX package pads the signal so that the frames cover
all of it (``torch.stft`` drops the tail), and divides the overlap-add by
the summed squared window.  The transforms are ``torch.fft.rfft``/``irfft``;
the JAX package's matmul-DFT was a TPU workaround and is not ported.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import profiling
from ..utils.config import StftConfig


def hann(win: int, device=None, dtype=torch.float32) -> torch.Tensor:
    """Periodic Hann window, built in float64 numpy as the JAX package does
    and copied to `device` in float32 at each call."""
    n = np.arange(win)
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)
    return profiling.to_device(w.astype(np.float32), device).to(dtype)


def frame(x: torch.Tensor, win: int, hop: int) -> torch.Tensor:
    """(..., T) -> (..., n_frames, win)."""
    return x.unfold(-1, win, hop)


def overlap_add(frames: torch.Tensor, hop: int, out_len: int) -> torch.Tensor:
    """(..., n_frames, win) -> (..., out_len), for ``win % hop == 0``.

    Each frame is cut into ``win // hop`` hop-sized chunks and the shifted
    streams are summed in the JAX package's order."""
    n_frames, win = frames.shape[-2], frames.shape[-1]
    if win % hop:
        raise ValueError(f"overlap_add needs win % hop == 0, got {win}, {hop}")
    lead = frames.shape[:-2]
    k = win // hop
    fr = frames.reshape(lead + (n_frames, k, hop))
    full = (n_frames + k - 1) * hop
    out = None
    for j in range(k):
        c = fr[..., :, j, :].reshape(lead + (n_frames * hop,))
        c = F.pad(c, (j * hop, full - (j + n_frames) * hop))
        out = c if out is None else out + c
    if out_len <= full:
        return out[..., :out_len]
    return F.pad(out, (0, out_len - full))


def _pad_last(x: torch.Tensor, left: int, right: int, mode: str = "constant") -> torch.Tensor:
    if mode == "constant":
        return F.pad(x, (left, right))
    # reflect/replicate padding wants a (N, C, L) view
    lead = x.shape[:-1]
    y = F.pad(x.reshape(-1, 1, x.shape[-1]), (left, right), mode=mode)
    return y.reshape(lead + (y.shape[-1],))


def stft(x: torch.Tensor, cfg: StftConfig = StftConfig(), center: bool = True) -> torch.Tensor:
    """(..., T) real -> (..., n_frames, n_fft//2+1) complex64."""
    if center:
        x = _pad_last(x, cfg.n_fft // 2, cfg.n_fft // 2, mode="reflect")
    t = x.shape[-1]
    tail = (t - cfg.win) % cfg.hop
    if tail:
        x = _pad_last(x, 0, cfg.hop - tail)
    frames = frame(x, cfg.win, cfg.hop) * hann(cfg.win, x.device, x.dtype)
    if cfg.win < cfg.n_fft:
        frames = F.pad(frames, (0, cfg.n_fft - cfg.win))
    return torch.fft.rfft(frames, n=cfg.n_fft, dim=-1)


def istft(
    spec: torch.Tensor,
    cfg: StftConfig = StftConfig(),
    length: int | None = None,
    center: bool = True,
) -> torch.Tensor:
    """Inverse of :func:`stft` with window-square COLA normalization."""
    frames = torch.fft.irfft(spec, n=cfg.n_fft, dim=-1)[..., : cfg.win]
    w = hann(cfg.win, frames.device, frames.dtype)
    frames = frames * w
    n_frames = spec.shape[-2]
    full_len = cfg.win + (n_frames - 1) * cfg.hop
    sig = overlap_add(frames, cfg.hop, full_len)
    wsq = overlap_add((w * w).expand(n_frames, cfg.win), cfg.hop, full_len)
    sig = sig / torch.clamp(wsq, min=1e-8)
    if center:
        sig = sig[..., cfg.n_fft // 2 : full_len - cfg.n_fft // 2]
    if length is not None:
        sig = sig[..., :length]
        if sig.shape[-1] < length:
            sig = F.pad(sig, (0, length - sig.shape[-1]))
    return sig


def spectrogram(x: torch.Tensor, cfg: StftConfig = StftConfig(), power: float = 1.0) -> torch.Tensor:
    """Magnitude (power=1) or power (power=2) spectrogram."""
    s = stft(x, cfg).abs()
    return s if power == 1.0 else s**power


def num_frames(t: int, cfg: StftConfig, center: bool = True) -> int:
    """Frame count for a length-t signal (matches :func:`stft`)."""
    if center:
        t = t + 2 * (cfg.n_fft // 2)
    return 1 + -(-(t - cfg.win) // cfg.hop)
