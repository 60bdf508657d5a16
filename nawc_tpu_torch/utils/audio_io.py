"""WAV read/write without torchaudio/soundfile (``nawc_tpu/utils/audio_io.py``,
kept as the port's own copy): the stdlib ``wave`` module + numpy, 16/24/32-bit
PCM and 32-bit float WAVs, mono or multichannel, returned as float32 in
[-1, 1].
"""

from __future__ import annotations

import struct
import wave
from pathlib import Path

import numpy as np


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a WAV file -> (audio (C, T) float32 in [-1,1], sample_rate)."""
    path = str(path)
    with open(path, "rb") as f:
        header = f.read(12)
    if header[:4] != b"RIFF" or header[8:12] != b"WAVE":
        raise ValueError(f"{path}: not a RIFF/WAVE file")
    # wave module handles PCM; float32 WAVs need manual chunk walk.
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            sw = w.getsampwidth()
            raw = w.readframes(w.getnframes())
        data = _decode_pcm(raw, sw)
    except wave.Error:
        data, sr, n_ch = _read_wav_manual(path)
    audio = data.reshape(-1, n_ch).T.astype(np.float32)
    return audio, sr


def _decode_pcm(raw: bytes, sampwidth: int) -> np.ndarray:
    if sampwidth == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    if sampwidth == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    if sampwidth == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        return vals.astype(np.float32) / float(1 << 23)
    if sampwidth == 1:
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    raise ValueError(f"unsupported sample width {sampwidth}")


def _read_wav_manual(path: str) -> tuple[np.ndarray, int, int]:
    """Chunk-walk for IEEE-float WAVs the stdlib wave module rejects."""
    with open(path, "rb") as f:
        f.seek(12)
        fmt = None
        data = None
        while True:
            hdr = f.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            if cid == b"fmt ":
                fmt = f.read(size)
            elif cid == b"data":
                data = f.read(size)
            else:
                f.seek(size + (size & 1), 1)
    if fmt is None or data is None:
        raise ValueError(f"{path}: missing fmt/data chunk")
    audio_fmt, n_ch, sr, _, _, bits = struct.unpack("<HHIIHH", fmt[:16])
    if audio_fmt == 3 and bits == 32:  # IEEE float
        arr = np.frombuffer(data, dtype="<f4").astype(np.float32)
    elif audio_fmt in (1, 0xFFFE):
        arr = _decode_pcm(data, bits // 8)
    else:
        raise ValueError(f"{path}: unsupported wav format {audio_fmt}")
    return arr, sr, n_ch


def write_wav(path: str | Path, audio: np.ndarray, sample_rate: int) -> None:
    """Write float32 audio ((T,) or (C, T), [-1,1]) as 16-bit PCM WAV."""
    audio = np.asarray(audio, dtype=np.float32)
    if audio.ndim == 1:
        audio = audio[None, :]
    n_ch, _ = audio.shape
    pcm = np.clip(audio.T, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype("<i2")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(n_ch)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())
