"""Quality evaluation of clean/watermarked pairs (``nawc_tpu/eval/quality.py``):
the reference's ``audio_quality_check/evaluate_quality.py`` pipeline (pairs
in, ``*_quality_results.csv`` rows out), the SNR, SI-SNR, LSD and
approximate-STOI columns batched on the device, exact STOI and PESQ on the
host."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from ..dsp.resample import resample
from ..utils import audio_io
from ..utils.config import StftConfig
from ..utils.device import resolve_device
from .metrics import lsd, pesq_host, si_snr, snr, stoi

# The reference computes EVERY quality metric at 16 kHz regardless of the
# method's native rate (``evaluate_quality.py:20-27`` resamples both files),
# with LSD over an n_fft=1024 / hop=512 magnitude STFT (``:45-52``).  Both
# signals go through the SAME resample, so the comparison measures
# resample(marked - clean) and adds no resampling artifact of its own.
REF_EVAL_SR = 16_000
_REF_LSD_CFG = StftConfig(1024, 512, 1024)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


def evaluate_pair_batch(clean: torch.Tensor, marked: torch.Tensor, sr: int,
                        with_pesq: bool = False) -> dict[str, np.ndarray]:
    """(B, T) x2 at the embed rate ``sr`` -> metric columns (named like
    ``evaluate_quality.py:54-78``), measured under the reference protocol.

    The SNR, SI-SNR, LSD and ``stoi_dev`` columns are computed on the
    tensors' device and fetched as float32; ``stoi`` (the exact,
    pystoi-algorithm measure) and ``pesq`` are float64 from the host.
    ``lsd_native`` is the LSD at the NATIVE rate, before the resample: the
    16 kHz protocol cannot see a 24 kHz method's 8-12 kHz band."""
    from .stoi_exact import stoi_exact_batch

    lsd_native = _host(lsd(clean, marked, _REF_LSD_CFG))
    if sr != REF_EVAL_SR:
        clean = resample(clean, sr, REF_EVAL_SR)
        marked = resample(marked, sr, REF_EVAL_SR)
    clean_np, marked_np = _host(clean), _host(marked)
    si_c = _host(si_snr(clean, clean))
    si_w = _host(si_snr(clean, marked))
    cols = {
        "si_snr_clean": si_c,
        "si_snr_watermarked": si_w,
        "delta_si_snr": si_w - si_c,
        "snr": _host(snr(clean, marked)),
        "lsd": _host(lsd(clean, marked, _REF_LSD_CFG)),
        "stoi": stoi_exact_batch(clean_np, marked_np, REF_EVAL_SR),
        "stoi_dev": _host(stoi(clean, marked, REF_EVAL_SR)),
        "lsd_native": lsd_native,
    }
    if with_pesq:
        cols["pesq"] = np.asarray([pesq_host(clean_np[i], marked_np[i], REF_EVAL_SR)
                                   for i in range(clean_np.shape[0])])
    return cols


def evaluate_pairs(pairs: list[tuple[str, str]], sr: int = 16_000, with_pesq: bool = True,
                   device: str | torch.device = "cuda") -> list[dict]:
    """pairs = [(clean_path, marked_path)] -> rows with the reference
    quality-results schema (``evaluate_quality.py:80-115``): ``clean``,
    ``watermarked``, ``attack``, ``instrument``, then the metric columns.
    Each file is mixed to mono, resampled to `sr` and cut to the shortest."""
    dev = resolve_device(device)
    cleans, markeds = [], []
    for cp, mp in pairs:
        c, csr = audio_io.read_wav(cp)
        m, msr = audio_io.read_wav(mp)
        c = torch.from_numpy(c.mean(axis=0)).to(dev)
        m = torch.from_numpy(m.mean(axis=0)).to(dev)
        if csr != sr:
            c = resample(c, csr, sr)
        if msr != sr:
            m = resample(m, msr, sr)
        t = min(c.shape[-1], m.shape[-1])
        cleans.append(c[:t])
        markeds.append(m[:t])
    t_min = min(c.shape[-1] for c in cleans)
    cols = evaluate_pair_batch(torch.stack([c[:t_min] for c in cleans]),
                               torch.stack([m[:t_min] for m in markeds]), sr, with_pesq=with_pesq)
    rows = []
    for i, (cp, mp) in enumerate(pairs):
        row = {"clean": cp, "watermarked": mp, "attack": "", "instrument": "speech"}
        row.update({k: float(v[i]) for k, v in cols.items()})
        rows.append(row)
    return rows


def make_pairs(results_dir: str | Path) -> list[tuple[str, str]]:
    """Walk a results tree pairing 1_original.wav / 2_watermarked.wav
    (``audio_quality_check/make_pairs.py:4-38``)."""
    out = []
    for orig in sorted(Path(results_dir).rglob("1_original.wav")):
        marked = orig.parent / "2_watermarked.wav"
        if marked.exists():
            out.append((str(orig), str(marked)))
    return out
