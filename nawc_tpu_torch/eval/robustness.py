"""raw_bench-style robustness runner (``nawc_tpu/eval/robustness.py``):
per-chunk results with the reference's CSV schema.

Audio is chunked (the chunks form one batch), each chunk is embedded,
attacked and detected, and the "no_watermark" control columns come from
the detector on the clean chunks.  Tables are lists of row dicts
(:mod:`..interp.feature_importance`), not pandas DataFrames, and are
written with the ``csv`` module.
"""

from __future__ import annotations

import csv
import math
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..interp.feature_importance import Row, agg_stats, columns
from ..models.base import random_message
from ..utils import jaxrand
from ..utils.device import resolve_device
from .metrics import si_snr


def chunk_audio(wav: np.ndarray, sr: int, chunk_seconds: float = 2.0) -> tuple[np.ndarray, np.ndarray]:
    """(T,) -> ((n_chunks, chunk_len), chunk_index array)."""
    c = int(chunk_seconds * sr)
    n = max(len(wav) // c, 1)
    if len(wav) < c:
        wav = np.pad(wav, (0, c - len(wav)))
    return wav[: n * c].reshape(n, c), np.arange(n)


def _host(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().numpy()


@torch.no_grad()
def run_robustness(
    wm,
    attacks: dict[str, Callable],
    clips: list[np.ndarray],
    sr: int,
    chunk_seconds: float = 2.0,
    hard_threshold: float = 0.5,
    seed: int = 0,
    sync: bool = False,
    detect_batch: int | None = None,
    device: str | torch.device = "cuda",
) -> list[Row]:
    """-> rows with the raw_bench per-chunk schema.

    bitwise/* = bit accuracy against the embedded payload (about 0.5 when
    absent); hard/* = the presence decision at `hard_threshold`; sisnr_wm =
    SI-SNR of the marked against the clean chunk; sisnr_attack = SI-SNR of
    the attacked against the marked chunk.  One key, ``prng_key(seed)``,
    draws the payload and serves the embed and every attack, as in JAX.
    `detect_batch` detects in sub-batches of that many chunks (a memory
    bound; the results are the same)."""
    dev = resolve_device(device)
    key = jaxrand.prng_key(seed)
    all_chunks, idx_rows = [], []
    for ci, clip in enumerate(clips):
        chunks, idx = chunk_audio(np.asarray(clip), sr, chunk_seconds)
        all_chunks.append(chunks)
        idx_rows += [(ci, int(j)) for j in idx]
    batch = torch.from_numpy(np.concatenate(all_chunks).astype(np.float32)).to(dev)
    b = batch.shape[0]

    has_bits = getattr(wm, "n_bits", 0) > 0
    msg = random_message(key, b, wm.n_bits, device=dev) if has_bits else None
    marked = wm.embed(batch, msg, key) if has_bits else wm.embed(batch)
    sisnr_wm = _host(si_snr(batch, marked))
    msg_host = _host(msg) if has_bits else None

    def detect_all(wav):
        db = detect_batch or wav.shape[0]
        ps, bs = [], []
        for i in range(0, wav.shape[0], db):
            w = wav[i : i + db]
            if sync and hasattr(wm, "detect_sync"):
                presence, bits, _ = wm.detect_sync(w)
            else:
                presence, bits = wm.detect(w)
            ps.append(_host(presence))
            bs.append(_host(bits))
        return np.concatenate(ps), np.concatenate(bs)

    def stats(wav):
        presence, bits = detect_all(wav)
        if has_bits:
            bitacc = (bits == msg_host).astype(np.float32).mean(axis=-1)
        else:
            bitacc = _host(wm.score(wav))  # semantic methods report the raw score here
        return bitacc, (presence > hard_threshold).astype(np.float32)

    bit_clean, hard_clean = stats(marked)
    bit_nw_clean, hard_nw_clean = stats(batch)

    rows = []
    for aname, attack in attacks.items():
        attacked = attack(marked, key)
        attacked_nw = attack(batch, key)
        bit_dist, hard_dist = stats(attacked)
        bit_nw_dist, hard_nw_dist = stats(attacked_nw)
        sisnr_att = _host(si_snr(marked, attacked))
        for i, (ci, j) in enumerate(idx_rows):
            rows.append({
                "clip_index": ci,
                "chunk_index": j,
                "attack_type": aname,
                "bitwise/clean": float(bit_clean[i]),
                "bitwise/distorted": float(bit_dist[i]),
                "bitwise/no_watermark_clean": float(bit_nw_clean[i]),
                "bitwise/no_watermark_distorted": float(bit_nw_dist[i]),
                "hard/clean": float(hard_clean[i]),
                "hard/distorted": float(hard_dist[i]),
                "hard/no_watermark_clean": float(hard_nw_clean[i]),
                "hard/no_watermark_distorted": float(hard_nw_dist[i]),
                "sisnr_wm": float(sisnr_wm[i]),
                "sisnr_attack": float(sisnr_att[i]),
            })
    return rows


def _cell(v) -> str:
    """A value as pandas' ``to_csv`` writes it: floats by their shortest
    repr in their own precision (float32 as float32), NaN empty."""
    if isinstance(v, (float, np.floating)):
        return "" if math.isnan(v) else str(v)
    return str(v)


def write_csv(rows: list[Row], path: str | Path, sep: str = ",") -> None:
    """The table as CSV, the header first, a missing value empty."""
    cols = columns(rows)
    with open(path, "w", newline="") as f:
        w = csv.writer(f, delimiter=sep, lineterminator="\n")
        w.writerow(cols)
        for r in rows:
            w.writerow([_cell(r.get(c, math.nan)) for c in cols])


def _parse(s: str):
    if s == "":
        return math.nan
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            pass
    return s


def read_csv(path: str | Path, sep: str = ",") -> list[Row]:
    """A table written by :func:`write_csv`, numbers parsed back."""
    with open(path, newline="") as f:
        return [{k: _parse(v) for k, v in r.items()} for r in csv.DictReader(f, delimiter=sep)]


def write_results_csv(rows: list[Row], path: str | Path) -> None:
    """Pipe-delimited, like raw_bench's test_results_*.csv."""
    write_csv(rows, path, sep="|")


def overall_stats(rows: list[Row]) -> list[Row]:
    """The reference's overall_stats.csv schema: n, then the mean and std of
    every numeric column over all rows."""
    tmp = [{**{k: v for k, v in r.items() if k != "attack_type"}, "_all": 0} for r in rows]
    return [{k: v for k, v in r.items() if k != "_all"} for r in agg_stats(tmp, ["_all"])]


def stats_by_attack(rows: list[Row]) -> list[Row]:
    """The reference's stats_by_attack.csv schema."""
    return agg_stats(rows, ["attack_type"])
