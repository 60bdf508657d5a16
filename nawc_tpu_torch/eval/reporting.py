"""Artifact writers with the reference's output contracts
(``nawc_tpu/eval/reporting.py``): the per-clip artifact WAVs and their
6-panel comparison PNG (``watermark_testing.py:682-750``), the ablation
heatmap, survival bars and group boxplots, and the quality-results rows
(``evaluate_quality.py:80-115``).  Outputs go to an explicit ``out_dir``.

The plots take lists of row dicts (see :mod:`.figures`) and import
matplotlib inside; ``save_artifacts`` writes its WAVs without it and draws
the PNG only where :func:`.figures.available`.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import audio_io
from . import figures
from .figures import _col, _groups, _plt, _save, pivot_mean


def save_artifacts(out_dir: str | Path, name: str, clean: np.ndarray, marked: np.ndarray,
                   attacked: np.ndarray, sr: int) -> None:
    """``<out_dir>/<name>/{1_original,2_watermarked,3_attacked}.wav`` and,
    with matplotlib, the 6-panel ``comparison.png``."""
    out = Path(out_dir) / name
    out.mkdir(parents=True, exist_ok=True)
    audio_io.write_wav(out / "1_original.wav", clean, sr)
    audio_io.write_wav(out / "2_watermarked.wav", marked, sr)
    audio_io.write_wav(out / "3_attacked.wav", attacked, sr)
    if not figures.available():
        return
    plt = _plt()
    fig, axes = plt.subplots(3, 2, figsize=(12, 8))
    for row, (sig, title) in enumerate([(clean, "original"), (marked, "watermarked"), (attacked, "attacked")]):
        sig = np.asarray(sig).ravel()
        axes[row, 0].plot(sig[:: max(len(sig) // 4000, 1)], linewidth=0.5)
        axes[row, 0].set_title(f"{title} waveform")
        f = np.abs(np.fft.rfft(sig))
        axes[row, 1].semilogy(np.maximum(f[:: max(len(f) // 4000, 1)], 1e-8), linewidth=0.5)
        axes[row, 1].set_title(f"{title} spectrum")
    fig.tight_layout()
    fig.savefig(out / "comparison.png", dpi=80)
    plt.close(fig)


def plot_ablation_heatmap(rows: list[dict], out_path: str | Path) -> None:
    """Mask x watermark heatmap of mean scores."""
    plt = _plt()
    masks, wms, values = pivot_mean(rows, "mask", "watermark", "score")
    fig, ax = plt.subplots(figsize=(2 + len(wms) * 1.5, 1 + len(masks) * 0.6))
    im = ax.imshow(values, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(wms)), wms, rotation=30, ha="right")
    ax.set_yticks(range(len(masks)), masks)
    for i in range(len(masks)):
        for j in range(len(wms)):
            ax.text(j, i, f"{values[i, j]:.2f}", ha="center", va="center", fontsize=8, color="w")
    fig.colorbar(im, ax=ax, label="score")
    _save(fig, out_path)


def plot_survival_bars(rows: list[dict], out_path: str | Path) -> None:
    """Per-attack survival-rate bars per watermark: the bar chart pandas'
    ``pivot_table(...).plot.bar`` draws (bars 0.5 wide in all per attack,
    empty cells as 0, attack labels turned 90 degrees)."""
    plt = _plt()
    attacks, wms, rates = pivot_mean([r for r in rows if r["clip_index"] >= 0],
                                     "attack", "watermark", "survived")
    fig, ax = plt.subplots(figsize=(max(6, len(attacks) * 0.5), 4))
    colors = plt.rcParams["axes.prop_cycle"].by_key()["color"]
    ticks = np.arange(len(attacks))
    w = 0.5 / len(wms)
    for i, wm in enumerate(wms):
        ax.bar(ticks - 0.25 + (i + 0.5) * w, np.nan_to_num(rates[:, i], nan=0.0), w, label=wm,
               color=colors[i % len(colors)])
    ax.set_xlim(-0.5, len(attacks) - 0.5)
    ax.set_xticks(ticks)
    ax.set_xticklabels(attacks)
    plt.setp(ax.get_xticklabels(), rotation=90)
    ax.set_xlabel("attack")
    ax.set_ylabel("survival rate")
    ax.set_ylim(0, 1.05)
    ax.legend(fontsize=7)
    _save(fig, out_path)


def plot_variance_boxplots(rows: list[dict], out_path: str | Path, group_col: str = "attack_type",
                           var_col: str = "mc_var_prob") -> None:
    """Per-group MC-variance boxplots (NaN values and groups left out)."""
    plt = _plt()
    if any(group_col in r for r in rows):
        groups = _groups(rows, group_col)
        labels = list(groups)
        data = [_finite(_col(groups[g], var_col)) for g in labels]
    else:
        labels = ["all"]
        data = [_finite(_col(rows, var_col))]
    fig, ax = plt.subplots(figsize=(max(5, 0.6 * len(labels)), 4))
    ax.boxplot(data, tick_labels=[str(g) for g in labels])
    ax.set_ylabel(var_col)
    plt.setp(ax.get_xticklabels(), rotation=40, ha="right", fontsize=7)
    _save(fig, out_path)


def _finite(v: np.ndarray) -> np.ndarray:
    return v[~np.isnan(v.astype(np.float64))]


def plot_metric_boxplots(rows: list[dict], out_path: str | Path, group_col: str = "attack_type",
                         metric_col: str = "sisnr_attack") -> None:
    """Per-attack metric boxplots."""
    plot_variance_boxplots(rows, out_path, group_col, metric_col)


def quality_results_frame(clean_paths, marked_paths, metrics_rows) -> list[dict]:
    """Rows with the columns of the reference's ``*_quality_results.csv``:
    clean, watermarked, attack, instrument, then each row's metrics."""
    return [{"clean": cp, "watermarked": mp, "attack": "", "instrument": "speech", **m}
            for cp, mp, m in zip(clean_paths, marked_paths, metrics_rows)]
