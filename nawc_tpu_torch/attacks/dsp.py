"""The 20-attack DSP suite over (B, T) waveforms (``nawc_tpu/attacks/dsp.py``).

The families of the reference's raw_bench tables: gain, polarity, noise,
filters, EQ, quantization, dynamics, phase, time warps, reverb and the
mp3/aac/vorbis *surrogates* (band limit + masked spectral quantization,
flagged as behavioural stand-ins, not bit-exact codecs).  ``encodec`` and
``dac`` are the neural-codec round-trips of :mod:`.codec`.

The keyed attacks take a :mod:`..utils.jaxrand` key and draw what
``jax.random`` draws for the same key, on the waveform's device
(:mod:`..ops.jaxrand`: the draw kernel on the card).  The JAX package's
workarounds are kept where they change the numbers: ``phase_shift``
zero-pads its FFT to a power of two, ``time_stretch`` computes its
positions in float64 on the host, ``time_jitter`` clamps its integer index,
``aac`` delays by 30 ms and ``vorbis`` dithers subtractively with the
default key ``PRNGKey(0)``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

from ..dsp.stft import istft, stft
from ..ops import jaxrand as keyed
from ..utils import jaxrand
from ..utils.config import StftConfig
from ..utils.padding import fix_length

_SURROGATE_STFT = StftConfig(1024, 256, 1024)

# ---------------------------------------------------------------- helpers


def _fir_filter(wav: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """'SAME' FIR along the last axis: a cross-correlation, as ``lax.conv``
    is, padded (k // 2, (k - 1) // 2)."""
    k = kernel.shape[0]
    flat = F.pad(wav.reshape(-1, 1, wav.shape[-1]), (k // 2, (k - 1) // 2))
    out = F.conv1d(flat, kernel.reshape(1, 1, -1).to(wav))
    return out.reshape(wav.shape[:-1] + (out.shape[-1],))


@functools.lru_cache(maxsize=64)
def _sinc_kernel(cutoff: float, sr: int, taps: int = 101, high: bool = False) -> np.ndarray:
    """Hamming-windowed sinc low/high-pass kernel, built on the host."""
    fc = cutoff / (sr / 2)
    n = np.arange(taps) - (taps - 1) / 2
    h = fc * np.sinc(fc * n)
    h *= np.hamming(taps)
    h /= h.sum()
    if high:
        imp = np.zeros(taps)
        imp[(taps - 1) // 2] = 1.0
        h = imp - h
    return h.astype(np.float32)


def _sinc(wav: torch.Tensor, cutoff: float, sr: int, high: bool = False) -> torch.Tensor:
    return _fir_filter(wav, torch.from_numpy(_sinc_kernel(cutoff, sr, high=high)).to(wav.device))


def _frame_rms_db(wav: torch.Tensor, frame: int = 256) -> torch.Tensor:
    """(B, T) -> (B, T // frame) per-frame RMS in dBFS."""
    t = wav.shape[-1] - wav.shape[-1] % frame
    x = wav[..., :t].reshape(wav.shape[:-1] + (t // frame, frame))
    rms = torch.sqrt((x * x).mean(dim=-1) + 1e-10)
    return 20.0 * torch.log10(rms + 1e-10)


def _frame_gain(wav: torch.Tensor, g: torch.Tensor, frame: int) -> torch.Tensor:
    """wav times the per-frame gain g, held over each frame; the tail past
    the last whole frame keeps gain 1."""
    lin = fix_length(torch.repeat_interleave(g, frame, dim=-1), wav.shape[-1])
    return wav * torch.where(lin == 0, torch.ones_like(lin), lin)


# ---------------------------------------------------------------- attacks


def gain(wav: torch.Tensor, factor: float = 2.0) -> torch.Tensor:
    return torch.clamp(wav * factor, -1.0, 1.0)


def polarity(wav: torch.Tensor) -> torch.Tensor:
    return -wav


def gaussian_noise(wav: torch.Tensor, key: np.ndarray, snr_db: float = 40.0) -> torch.Tensor:
    p_sig = (wav**2).mean(dim=-1, keepdim=True)
    sigma = torch.sqrt(p_sig * 10.0 ** (-snr_db / 10.0))
    return wav + sigma * keyed.normal(key, wav.shape, wav.device)


def background_noise(wav: torch.Tensor, key: np.ndarray, snr_db: float = 25.0) -> torch.Tensor:
    """Coloured (low-passed at 2 kHz) noise at the given SNR."""
    n = _sinc(keyed.normal(key, wav.shape, wav.device), 2000.0, 16_000)
    p_sig = (wav**2).mean(dim=-1, keepdim=True)
    p_n = (n**2).mean(dim=-1, keepdim=True)
    return wav + n * torch.sqrt(p_sig / (p_n + 1e-12) * 10.0 ** (-snr_db / 10.0))


def lowpass(wav: torch.Tensor, cutoff_hz: float = 3500.0, sr: int = 16_000) -> torch.Tensor:
    return _sinc(wav, cutoff_hz, sr)


def highpass(wav: torch.Tensor, cutoff_hz: float = 500.0, sr: int = 16_000) -> torch.Tensor:
    return _sinc(wav, cutoff_hz, sr, high=True)


def eq(wav: torch.Tensor, key: np.ndarray, sr: int = 16_000, n_bumps: int = 5,
       depth_db: float = 6.0) -> torch.Tensor:
    """Random multi-band EQ: +-depth_db Gaussian bumps, applied zero-phase."""
    taps = 257
    dev = wav.device
    freqs = torch.from_numpy(np.linspace(0.0, 1.0, taps // 2 + 1).astype(np.float32)).to(dev)
    k1, k2, k3 = jaxrand.split(key, 3)
    centers = keyed.uniform(k1, (n_bumps,), dev, 0.05, 0.9)
    widths = keyed.uniform(k2, (n_bumps,), dev, 0.02, 0.15)
    gains = keyed.uniform(k3, (n_bumps,), dev, -depth_db, depth_db)
    bumps = torch.exp(-0.5 * ((freqs[None, :] - centers[:, None]) / widths[:, None]) ** 2)
    mag = 10.0 ** ((gains[:, None] * bumps).sum(dim=0) / 20.0)
    h = torch.fft.irfft(mag.to(torch.complex64), n=taps)
    h = torch.roll(h, taps // 2) * torch.from_numpy(np.hamming(taps).astype(np.float32)).to(dev)
    return _fir_filter(wav, h)


def quantization(wav: torch.Tensor, n_bits: int = 8) -> torch.Tensor:
    scale = float(2 ** (n_bits - 1))
    return torch.round(wav * scale) / scale  # round half to even, as jnp.round


def dynamic_range_compression(wav: torch.Tensor, thresh_db: float = -25.0, ratio: float = 4.0,
                              frame: int = 256) -> torch.Tensor:
    """Frame-RMS compressor (gain reduction above the threshold)."""
    db = _frame_rms_db(wav, frame)
    gain_db = torch.where(db > thresh_db, (thresh_db - db) * (1.0 - 1.0 / ratio),
                          torch.zeros_like(db))
    return _frame_gain(wav, 10.0 ** (gain_db / 20.0), frame)


def dynamic_range_expansion(wav: torch.Tensor, thresh_db: float = -35.0, ratio: float = 2.0,
                            frame: int = 256) -> torch.Tensor:
    """Downward expander: attenuates the frames below the threshold."""
    db = _frame_rms_db(wav, frame)
    gain_db = torch.where(db < thresh_db, (db - thresh_db) * (ratio - 1.0), torch.zeros_like(db))
    gain_db = torch.clamp(gain_db, min=-30.0)
    return _frame_gain(wav, 10.0 ** (gain_db / 20.0), frame)


def limiter(wav: torch.Tensor, limit: float = 0.3, frame: int = 64) -> torch.Tensor:
    t = wav.shape[-1] - wav.shape[-1] % frame
    x = wav[..., :t].reshape(wav.shape[:-1] + (t // frame, frame))
    peak = x.abs().amax(dim=-1)
    return _frame_gain(wav, torch.clamp(limit / (peak + 1e-9), max=1.0), frame)


def phase_shift(wav: torch.Tensor, phase: float = float(np.pi / 2)) -> torch.Tensor:
    """Constant spectral phase rotation (Hilbert-based all-pass), the FFT
    zero-padded to a power of two as in the JAX package."""
    t = wav.shape[-1]
    nfft = 1 << (t - 1).bit_length()
    spec = torch.fft.rfft(wav, n=nfft, dim=-1)
    rot = torch.exp(torch.tensor(1j * phase, dtype=torch.complex64, device=wav.device))
    return torch.fft.irfft(spec * rot, n=nfft, dim=-1)[..., :t].to(wav.dtype)


def time_jitter(wav: torch.Tensor, key: np.ndarray, max_ms: float = 2.0,
                sr: int = 16_000) -> torch.Tensor:
    """Smoothly varying local time warp (+-max_ms), linear-interpolation
    gather.  ``jax.image.resize(..., "linear")`` is half-pixel linear
    resampling with the edges clamped, which is ``F.interpolate``'s
    ``linear`` mode without ``align_corners``."""
    t = wav.shape[-1]
    lead = wav.shape[:-1]
    ctrl = keyed.uniform(key, lead + (32,), wav.device, -1.0, 1.0)
    offs = F.interpolate(ctrl.reshape(-1, 1, 32), size=t, mode="linear", align_corners=False)
    offs = offs.reshape(lead + (t,)) * (max_ms / 1000.0 * sr)
    pos = torch.clamp(torch.arange(t, dtype=wav.dtype, device=wav.device) + offs, 0.0, t - 1.001)
    # the integer clamp: at large T the float32 bound t - 1.001 rounds up to
    # t - 1, and i0 + 1 would index past the end
    i0 = torch.clamp(torch.floor(pos).to(torch.int64), max=t - 2)
    frac = torch.clamp(pos - i0, 0.0, 1.0)
    x0 = torch.gather(wav, -1, i0)
    x1 = torch.gather(wav, -1, i0 + 1)
    return x0 * (1 - frac) + x1 * frac


def time_stretch(wav: torch.Tensor, rate_permyriad: int = 9500) -> torch.Tensor:
    """Speed change by playback-rate warping, rate in 1/10000 units, as a
    linear-interpolation gather.  The positions are computed on the host in
    float64, so they keep sub-sample accuracy at any clip length."""
    t = wav.shape[-1]
    dev = wav.device
    pos = np.arange(t, dtype=np.float64) * (10_000.0 / float(rate_permyriad))
    valid = torch.from_numpy(pos <= (t - 1)).to(dev)
    pos = np.clip(pos, 0.0, t - 1)
    i0_np = np.minimum(np.floor(pos), t - 2).astype(np.int64)
    i0 = torch.from_numpy(i0_np).to(dev)
    frac = torch.from_numpy(np.clip(pos - i0_np, 0.0, 1.0).astype(np.float32)).to(dev).to(wav.dtype)
    y = wav[..., i0] * (1 - frac) + wav[..., i0 + 1] * frac
    # samples past the (shorter) stretched signal are silence
    return torch.where(valid, y, torch.zeros_like(y))


def reverb(wav: torch.Tensor, key: np.ndarray, rt60_ms: float = 300.0, sr: int = 16_000,
           wet: float = 0.4) -> torch.Tensor:
    """Synthetic exponentially decaying noise RIR, FFT convolution."""
    n_ir = int(sr * rt60_ms / 1000.0)
    tau = rt60_ms / 1000.0 / 6.9  # RT60 = the time to -60 dB
    tt = torch.arange(n_ir, device=wav.device) / sr
    ir = keyed.normal(key, (n_ir,), wav.device) * torch.exp(-tt / tau)
    ir = ir / (torch.linalg.vector_norm(ir) + 1e-9)
    n = wav.shape[-1] + n_ir - 1
    nfft = 1 << int(np.ceil(np.log2(max(n, 2))))
    out = torch.fft.irfft(torch.fft.rfft(wav, n=nfft, dim=-1) * torch.fft.rfft(ir, n=nfft),
                          n=nfft, dim=-1)[..., : wav.shape[-1]]
    return (1.0 - wet) * wav + wet * out.to(wav.dtype)


def _surrogate_spectrum(
    wav: torch.Tensor, sr: int, bandwidth_hz: float, step_db: float, dither: np.ndarray | None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The perceptual-codec surrogate's spectrum: -> (quantised magnitude,
    unit phase).

    Band limit, log-magnitude quantisation with steps coarser at high
    frequency, and truncation 40 dB below each frame's peak.  With a
    `dither` key the quantiser is subtractively dithered:
    (round(x / step + u) - u) * step, u ~ U(-1/2, 1/2)."""
    spec = stft(wav, _SURROGATE_STFT)
    mag = spec.abs()
    phase = spec / (mag + 1e-9)
    n_bins = mag.shape[-1]
    freqs = torch.from_numpy(np.linspace(0, sr / 2, n_bins).astype(np.float32)).to(wav.device)
    band = (freqs <= bandwidth_hz).to(mag.dtype)
    logmag = torch.log10(mag + 1e-9) * 20.0
    step = step_db * (1.0 + 2.0 * (freqs / (sr / 2)))
    if dither is None:
        q = torch.round(logmag / step) * step
    else:
        u = keyed.uniform(dither, logmag.shape, wav.device, -0.5, 0.5)
        q = (torch.round(logmag / step + u) - u) * step
    keep = (logmag > logmag.amax(dim=-1, keepdim=True) - 40.0).to(mag.dtype)
    return 10.0 ** (q / 20.0) * keep * band, phase


def lossy_codec_surrogate(wav: torch.Tensor, sr: int = 16_000, bandwidth_hz: float = 7000.0,
                          step_db: float = 1.5) -> torch.Tensor:
    """Perceptual-codec SURROGATE for mp3/aac/vorbis: a behavioural stand-in,
    NOT a bit-exact codec."""
    mag_q, phase = _surrogate_spectrum(wav, sr, bandwidth_hz, step_db, None)
    return istft(mag_q * phase, _SURROGATE_STFT, length=wav.shape[-1])


def mp3(wav: torch.Tensor, sr: int = 16_000) -> torch.Tensor:
    return lossy_codec_surrogate(wav, sr, bandwidth_hz=0.8 * sr / 2, step_db=0.5)


def aac(wav: torch.Tensor, sr: int = 16_000) -> torch.Tensor:
    """The surrogate delayed by 30 ms: the real AAC encoder's delay is the
    dominant artefact of the reference's aac rows."""
    delay = int(round(0.030 * sr))
    y = lossy_codec_surrogate(wav, sr, bandwidth_hz=0.9 * sr / 2, step_db=1.0)
    return F.pad(y, (delay, 0))[..., : wav.shape[-1]]


def vorbis(wav: torch.Tensor, key: np.ndarray | None = None, sr: int = 16_000,
           bandwidth_hz: float | None = None, step_db: float = 4.5) -> torch.Tensor:
    """Vorbis surrogate with subtractively dithered quantisation: the error
    is uniform, white and independent of the signal, as real Vorbis
    noise-filling makes it, at the error power of the plain rounder."""
    if bandwidth_hz is None:
        bandwidth_hz = 0.85 * sr / 2
    if key is None:
        key = jaxrand.prng_key(0)
    mag_q, phase = _surrogate_spectrum(wav, sr, bandwidth_hz, step_db, key)
    return istft(mag_q * phase, _SURROGATE_STFT, length=wav.shape[-1])
