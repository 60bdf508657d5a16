"""Artifact writers with the reference's output contracts
(``nawc_tpu/eval/reporting.py``): the per-clip artifact WAVs
(``watermark_testing.py:682-750``) and the quality-results rows
(``evaluate_quality.py:80-115``).  Outputs go to an explicit ``out_dir``.

Left out against the JAX module: the comparison PNG of ``save_artifacts``
and the ``plot_*`` functions, because the port does not use matplotlib.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import audio_io


def save_artifacts(out_dir: str | Path, name: str, clean: np.ndarray, marked: np.ndarray,
                   attacked: np.ndarray, sr: int) -> None:
    """``<out_dir>/<name>/{1_original,2_watermarked,3_attacked}.wav``."""
    out = Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    audio_io.write_wav(out / "1_original.wav", clean, sr)
    audio_io.write_wav(out / "2_watermarked.wav", marked, sr)
    audio_io.write_wav(out / "3_attacked.wav", attacked, sr)


def quality_results_frame(clean_paths, marked_paths, metrics_rows) -> list[dict]:
    """Rows with the columns of the reference's ``*_quality_results.csv``:
    clean, watermarked, attack, instrument, then each row's metrics."""
    return [{"clean": cp, "watermarked": mp, "attack": "", "instrument": "speech", **m}
            for cp, mp, m in zip(clean_paths, marked_paths, metrics_rows)]
