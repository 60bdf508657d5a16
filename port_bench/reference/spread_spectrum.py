"""The spread-spectrum watermark from its definition, in plain PyTorch.

Embed: the centred, Hann-windowed STFT (reflect padding of n_fft / 2, the
tail zero-padded so that the frames cover the signal); in the band
[lo, hi) the log-magnitude moves by alpha clamp(sum_b s_b P_b / sqrt(n), -3, 3)
with s = 2 msg - 1 and P_b bit b's +-1 pattern (cells of 4 frames x 4
bins, a 64-frame period, drawn by ``bernoulli(fold_in(PRNGKey(seed), b))``);
the inverse STFT by overlap-add over the summed squared window; then
n_passes - 1 corrections of what the resynthesis lost (clamped to +-0.5),
and the result clamped to [-1, 1].

Detect: the band's log-magnitude less its 15-bin moving average over
frequency (edge padding), whitened per bin over time ((r - mean) /
(std + 0.2), then the grand mean taken out), correlated with each time-
centred pattern and with its cyclic time rolls by the null offsets;
z = corr / (rms of the null correlations + 1e-8), presence
sigmoid(gain (mean |z| - z0)), bits z > 0.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import threefry
from .precision import Precision, _same


def hann(win: int, device) -> torch.Tensor:
    n = np.arange(win)
    return torch.as_tensor((0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)).astype(np.float32),
                           device=device)


def stft(x: torch.Tensor, n_fft: int, hop: int, rnd=_same) -> torch.Tensor:
    """(B, T) -> (B, frames, n_fft / 2 + 1) complex; `rnd` rounds the
    transform's input and output."""
    x = F.pad(rnd(x)[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    tail = (x.shape[-1] - n_fft) % hop
    if tail:
        x = F.pad(x, (0, hop - tail))
    spec = torch.fft.rfft(x.unfold(-1, n_fft, hop) * hann(n_fft, x.device), dim=-1)
    return spec if rnd is _same else torch.complex(rnd(spec.real), rnd(spec.imag))


def istft(spec: torch.Tensor, n_fft: int, hop: int, length: int, rnd=_same) -> torch.Tensor:
    """Overlap-add over the summed squared window, centred, cut or padded
    to `length`."""
    w = hann(n_fft, spec.device)
    frames = rnd(torch.fft.irfft(spec, n=n_fft, dim=-1)) * w  # (B, N, n_fft)
    n = frames.shape[-2]
    full = n_fft + (n - 1) * hop

    def ola(fr):  # (B, N, n_fft) -> (B, full)
        return F.fold(fr.transpose(1, 2), (1, full), (1, n_fft), stride=(1, hop))[:, 0, 0]

    sig = ola(frames) / torch.clamp(ola((w * w).expand(1, n, n_fft)), min=1e-8)
    sig = sig[:, n_fft // 2: full - n_fft // 2][:, :length]
    return F.pad(sig, (0, length - sig.shape[-1]))


def band(cfg: dict) -> tuple[int, int]:
    top = cfg["n_fft"] // 2
    lo = int(round(cfg["band_lo_hz"] / (cfg["sample_rate"] / 2) * top))
    hi = int(round(cfg["band_hi_hz"] / (cfg["sample_rate"] / 2) * top))
    return lo, max(hi, lo + 8)


@functools.lru_cache(maxsize=8)
def _patterns(seed: int, n_bits: int, width: int, period: int, tcell: int, fcell: int) -> np.ndarray:
    key = threefry.prng_key(seed)
    tc, fc = period // tcell, -(-width // fcell)
    bits = np.stack([threefry.bernoulli(threefry.fold_in(key, b), 0.5, (tc, fc))
                     for b in range(n_bits)])
    p = 2.0 * bits.astype(np.float32) - 1.0
    return np.repeat(np.repeat(p, tcell, axis=1), fcell, axis=2)[:, :, :width]


def patterns(cfg: dict, frames: int, device) -> torch.Tensor:
    """(n_bits, frames, band width) +-1, the period tiled along time."""
    lo, hi = band(cfg)
    p = torch.as_tensor(_patterns(cfg["seed"], cfg["n_bits"], hi - lo, cfg["pn_period"],
                                  cfg["time_cell"], cfg["freq_cell"]), device=device)
    reps = -(-frames // cfg["pn_period"])
    return p.repeat(1, reps, 1)[:, :frames]


def embed(cfg: dict, prec: Precision, wav: torch.Tensor, msg: torch.Tensor) -> torch.Tensor:
    n_fft, hop, t = cfg["n_fft"], cfg["hop"], wav.shape[-1]
    lo, hi = band(cfg)
    d = prec.dsp
    spec = stft(wav, n_fft, hop, d)
    p = patterns(cfg, spec.shape[-2], wav.device)
    s = 2.0 * msg.float() - 1.0
    mod = torch.einsum("bk,ktw->btw", prec.wide(s), prec.wide(p)) / math.sqrt(cfg["n_bits"])
    want = cfg["alpha"] * torch.clamp(mod, -3.0, 3.0)
    log_clean = d(torch.log(spec.abs() + 1e-6))
    gain = torch.ones_like(spec.real)
    gain[..., lo:hi] += want
    marked = istft(spec * gain, n_fft, hop, t, d)
    for _ in range(cfg["n_passes"] - 1):
        sm = stft(marked, n_fft, hop, d)
        fix = torch.clamp(want - (d(torch.log(sm.abs() + 1e-6)) - log_clean)[..., lo:hi], -0.5, 0.5)
        gain = torch.ones_like(sm.real)
        gain[..., lo:hi] += fix
        marked = istft(sm * gain, n_fft, hop, t, d)
    return torch.clamp(marked, -1.0, 1.0)


def zstats(cfg: dict, prec: Precision, wav: torch.Tensor) -> torch.Tensor:
    """(B, T) -> (B, n_bits) calibrated correlation statistics."""
    lo, hi = band(cfg)
    logmag = prec.dsp(torch.log(stft(wav, cfg["n_fft"], cfg["hop"], prec.dsp).abs() + 1e-6))
    b, n, f = logmag.shape
    half = cfg["smooth_bins"] // 2
    env = F.avg_pool1d(F.pad(logmag.reshape(b * n, 1, f), (half, half), mode="replicate"),
                       cfg["smooth_bins"], stride=1).reshape(b, n, f)
    r = (logmag - env)[..., lo:hi]
    rw = (r - r.mean(dim=1, keepdim=True)) / (r.std(dim=1, keepdim=True, correction=0) + 0.2)
    rw = prec.wide(rw - rw.mean(dim=(1, 2), keepdim=True))
    p = patterns(cfg, n, wav.device)
    pc = prec.wide(p - p.mean(dim=1, keepdim=True))
    corr = torch.einsum("btw,ktw->bk", rw, pc)
    nulls = torch.stack([torch.einsum("btw,ktw->bk", rw, torch.roll(pc, o, dims=1))
                         for o in cfg["null_offsets"]], dim=-1)
    return corr / (torch.sqrt((nulls ** 2).mean(dim=(1, 2)))[:, None] + 1e-8)


def detect(cfg: dict, prec: Precision, wav: torch.Tensor):
    """-> (presence (B,), bits (B, n_bits) int32, z (B, n_bits))."""
    z = zstats(cfg, prec, wav)
    presence = torch.sigmoid(cfg["presence_gain"] * (z.abs().mean(dim=-1) - cfg["presence_z0"]))
    return presence, (z > 0).to(torch.int32), z
