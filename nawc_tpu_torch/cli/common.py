"""Shared CLI plumbing (``nawc_tpu/cli/common.py``): audio loading, the
codec and watermarker construction, and the probe preflight."""

from __future__ import annotations

import glob as globlib
from pathlib import Path

import numpy as np
import torch

# clips are looked up relative to the working directory (``data/`` is
# git-ignored); the JAX package's default names the reference dataset's
# absolute location
DEFAULT_AUDIO_GLOB = "data/LibriSpeech/*.wav"

WM_CHOICES = (
    "spread_spectrum", "chunked", "psychoacoustic",
    "semantic_pca", "semantic_cluster", "semantic_random",
    "token_green", "neural",
)
NEURAL_CKPT = "checkpoints/neural_wm.msgpack"
_SEMANTIC_AXES = {"semantic_pca": "pca", "semantic_cluster": "kmeans", "semantic_random": "random"}


def load_audio_batch(
    audio_glob: str,
    count: int,
    sr: int,
    seconds: float = 2.0,
    offset: int = 0,
) -> torch.Tensor:
    """`count` clips as one (count, seconds * sr) CPU batch: mono,
    resampled to `sr`, truncated or zero-padded."""
    t = int(seconds * sr)
    clips = load_audio_clips(audio_glob, count, sr, seconds, offset)
    return torch.from_numpy(np.stack([np.pad(c, (0, t - len(c))) for c in clips]))


def load_audio_clips(
    audio_glob: str,
    count: int,
    sr: int,
    max_seconds: float,
    offset: int = 0,
) -> list[np.ndarray]:
    """Clips at their native length (capped at `max_seconds`), resampled to
    `sr`, mono: the robustness schema must not count fabricated silence."""
    from ..dsp.resample import resample
    from ..utils import audio_io

    files = sorted(globlib.glob(audio_glob))[offset : offset + count]
    if not files:
        raise SystemExit(f"no audio files match {audio_glob}")
    cap = int(max_seconds * sr)
    out = []
    for f in files:
        a, fsr = audio_io.read_wav(f)
        x = torch.from_numpy(a.mean(axis=0))
        if fsr != sr:
            x = resample(x, fsr, sr)
        out.append(x.numpy().astype(np.float32)[:cap])
    return out


CODEC_SIZES = ("full", "small", "snac44k")  # the --codec_size choices


def load_codec(ckpt: str | None, size: str = "full", device: str | torch.device = "cuda"):
    """A CodecState: JAX's seed-0 init of the `size` config (one of
    :data:`CODEC_SIZES`; "snac44k" is SNAC 44 kHz's published
    architecture), with the weights of `ckpt` when it exists."""
    from ..codec import load_codec as read_codec
    from ..codec import make_codec
    from ..utils.config import CodecConfig

    if size not in CODEC_SIZES:
        raise ValueError(f"load_codec: size {size!r} is none of {CODEC_SIZES}")
    cfg = {"full": CodecConfig, "snac44k": CodecConfig.snac_44khz}.get(size, lambda: CodecConfig(
        encoder_dim=8, latent_dim=64, decoder_dim=64, codebook_size=128, codebook_dim=8
    ))()
    if ckpt and Path(ckpt).exists():
        codec = read_codec(ckpt, cfg, device=device)
        print(f"[codec] restored weights from {ckpt}")
    else:
        codec = make_codec(cfg, device=device, seed=0)
        print(f"[codec] WARNING: no checkpoint at {ckpt!r}; using RANDOM weights "
              "(codec round-trips will destroy audio)")
    return codec


def preflight_probe(
    watermarks: list[str],
    codec_ckpt: str | None = None,
    codec_size: str = "full",
    sample_rate: int = 16_000,
    timeout_s: float = 900.0,
    audio_glob: str = DEFAULT_AUDIO_GLOB,
    device: str = "cuda",
) -> None:
    """Run ``python -m nawc_tpu_torch.cli.probe`` for each watermark in a
    disposable subprocess before a full-scale stage, and print its last
    line.  A probe that times out or exits non-zero ends the run
    (SystemExit) before the full-scale stage starts.  The probe reads the
    clips of `audio_glob` on `device`, and imports this copy of the
    package, wherever the working directory is."""
    import os
    import subprocess
    import sys

    root = str(Path(__file__).resolve().parents[2])
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}

    for name in watermarks:
        cmd = [
            sys.executable, "-m", "nawc_tpu_torch.cli.probe", "--watermark", name,
            "--sample_rate", str(sample_rate), "--codec_size", codec_size,
            "--audio_glob", audio_glob, "--device", device,
        ]
        if codec_ckpt:
            cmd += ["--codec_ckpt", codec_ckpt]
        print(f"[probe] preflight {name} (subprocess, timeout {timeout_s:.0f}s)", flush=True)
        try:
            proc = subprocess.run(cmd, timeout=timeout_s, capture_output=True, text=True, env=env)
        except subprocess.TimeoutExpired:
            raise SystemExit(f"[probe] {name} preflight TIMED OUT after {timeout_s:.0f}s; "
                             "refusing to run the full-scale stage") from None
        if proc.returncode != 0:
            tail = (proc.stderr or proc.stdout or "").strip().splitlines()[-8:]
            raise SystemExit(f"[probe] {name} preflight FAILED (rc={proc.returncode}); "
                             "refusing to run the full-scale stage.\n" + "\n".join(tail))
        lines = proc.stdout.strip().splitlines()
        print(f"[probe] {lines[-1] if lines else f'{name} preflight ok (no output)'}", flush=True)


def build_watermarkers(names: list[str], codec=None, sample_rate: int | None = None,
                       device: str | torch.device | None = None) -> dict[str, object]:
    """Name -> watermarker instance; the codec-latent ones need a codec.
    ``neural`` holds its networks on `device` (the codec's device when
    None, else the GPU): the trained ``checkpoints/neural_wm.msgpack`` when
    it exists, else JAX's seed-0 init."""
    from ..models import ChunkedWM, PsychoacousticWM, SemanticWM, SpreadSpectrumWM, TokenGreenWM
    from ..utils.config import SpreadSpectrumConfig

    out: dict[str, object] = {}
    for n in names:
        if n == "spread_spectrum":
            cfg = SpreadSpectrumConfig(alpha=0.1) if sample_rate is None else SpreadSpectrumConfig(
                sample_rate=sample_rate, band_hi_hz=min(0.45 * sample_rate, 9000.0), alpha=0.1
            )
            out[n] = SpreadSpectrumWM(cfg=cfg)
        elif n == "chunked":
            out[n] = ChunkedWM()
        elif n == "psychoacoustic":
            out[n] = PsychoacousticWM()
        elif n == "token_green":
            if codec is None:
                raise SystemExit(f"{n} requires a codec")
            out[n] = TokenGreenWM(codec)
        elif n in _SEMANTIC_AXES:
            if codec is None:
                raise SystemExit(f"{n} requires --codec_ckpt / codec")
            out[n] = SemanticWM(codec, _SEMANTIC_AXES[n])
        elif n == "neural":
            from ..models.neural import init_neural_wm, load_neural_wm

            dev = device if device is not None else codec.device if codec is not None else "cuda"
            if Path(NEURAL_CKPT).exists():
                out[n] = load_neural_wm(NEURAL_CKPT, device=dev)
                print(f"[neural] restored weights from {NEURAL_CKPT}")
            else:
                print("[neural] WARNING: no checkpoint; random weights (train with cli.train_wm)")
                out[n] = init_neural_wm(0, device=dev)
        else:
            raise SystemExit(f"unknown watermark {n!r}; choices: {WM_CHOICES}")
    return out
