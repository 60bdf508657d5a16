"""The reference's figures (``nawc_tpu/eval/figures.py``), drawn from the
port's tables: lists of row dicts where the JAX package takes DataFrames.
Groups and pivots come in pandas' sorted key order, and group means skip
NaN as pandas' do.

  * manifold global ΔWM-vs-ΔATT scatter, 3-D trajectory scatter, Δ bars,
    and the per-file projection triplets;
  * ablation per-watermark bar charts;
  * uncertainty variance histograms (correct vs wrong), the variance ROC
    and the reliability curve;
  * watermark-residual SNR histogram and spectral-footprint boxplot;
  * PGD dual-axis detection-vs-SNR chart and the Exp-C scatter;
  * the stats CLI's top-K feature-importance bars.

Host-side post-processing only: no device work happens here.  matplotlib
(Agg backend) is imported inside each function, so this module imports
without it; a ``plot_*`` call without it raises the ``ImportError``, and a
CLI asks :func:`available` first and names what it did not draw
(:func:`not_drawn`).
"""

from __future__ import annotations

import importlib.util
import math
from pathlib import Path

import numpy as np

Row = dict


def available() -> bool:
    """True iff matplotlib can be imported."""
    try:
        return importlib.util.find_spec("matplotlib") is not None
    except ImportError:
        return False


def not_drawn(paths) -> None:
    """The one line a CLI prints for the PNGs it did not draw."""
    print("[figures] matplotlib is not installed; not drawn: " + ", ".join(str(p) for p in paths))


def _plt():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save(fig, out_path: str | Path) -> None:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    import matplotlib.pyplot as plt

    plt.close(fig)


# ------------------------------------------------------------ tables


def _is_nan(v) -> bool:
    return isinstance(v, (float, np.floating)) and math.isnan(v)


def _col(rows: list[Row], name: str) -> np.ndarray:
    return np.array([r[name] for r in rows])


def _groups(rows: list[Row], key: str) -> dict:
    """pandas' ``groupby(key)``: sorted keys (NaN keys dropped), each
    group's rows in table order."""
    out: dict = {}
    for r in rows:
        if not _is_nan(r[key]):
            out.setdefault(r[key], []).append(r)
    return {k: out[k] for k in sorted(out)}


def _mean(values) -> float:
    """pandas' mean: NaN skipped, NaN when nothing is left."""
    v = np.asarray(values, np.float64)
    v = v[~np.isnan(v)]
    return float(v.mean()) if v.size else math.nan


def pivot_mean(rows: list[Row], index: str, columns: str, values: str):
    """pandas' ``pivot_table(index=, columns=, values=, aggfunc="mean")``
    -> (index keys, column keys, (n_index, n_columns) float64 means, NaN
    where a pair has no value), keys sorted."""
    cells: dict[tuple, list] = {}
    for r in rows:
        if not (_is_nan(r[index]) or _is_nan(r[columns])):
            cells.setdefault((r[index], r[columns]), []).append(r[values])
    means = {k: _mean(v) for k, v in cells.items()}
    means = {k: v for k, v in means.items() if not math.isnan(v)}
    rows_k = sorted({i for i, _ in means})
    cols_k = sorted({c for _, c in means})
    table = np.array([[means.get((i, c), math.nan) for c in cols_k] for i in rows_k], np.float64)
    return rows_k, cols_k, table.reshape(len(rows_k), len(cols_k))


# ------------------------------------------------------------ manifold


def plot_manifold_global(rows: list[Row], out_dir: str | Path, dataset: str = "all") -> list[Path]:
    """Global manifold summary: Δ scatter, 3-D scatter, Δ bars.  `rows`
    are ``run_manifold_analysis``'s (watermark, clean/wm/att_proj_mean,
    delta_wm, delta_att)."""
    plt = _plt()
    out_dir = Path(out_dir)
    groups = _groups(rows, "watermark")
    saved = []

    # ΔWM vs ΔATT scatter with the y=-x "full removal" guide line
    fig, ax = plt.subplots(figsize=(6, 6))
    for name, sub in groups.items():
        ax.scatter(_col(sub, "delta_wm"), _col(sub, "delta_att"), alpha=0.6, label=name, s=20)
    ax.axhline(0.0, color="gray", linewidth=1, linestyle="--")
    ax.axvline(0.0, color="gray", linewidth=1, linestyle="--")
    d = np.asarray(_col(rows, "delta_wm"), np.float64)
    xs = np.linspace(np.nanmin(d), np.nanmax(d), 100)
    ax.plot(xs, -xs, color="black", linewidth=1, linestyle=":")
    ax.set_xlabel("ΔWM = wm_proj_mean - clean_proj_mean")
    ax.set_ylabel("ΔATT = att_proj_mean - wm_proj_mean")
    ax.set_title(f"ΔWM vs ΔATT (all WMs, {dataset})")
    ax.legend(fontsize=8)
    p = out_dir / f"manifold_global_delta_{dataset}.png"
    _save(fig, p)
    saved.append(p)

    # 3-D clean -> wm -> att scatter
    fig = plt.figure(figsize=(7, 6))
    ax3 = fig.add_subplot(111, projection="3d")
    for name, sub in groups.items():
        ax3.scatter(_col(sub, "clean_proj_mean"), _col(sub, "wm_proj_mean"), _col(sub, "att_proj_mean"),
                    alpha=0.6, label=name, s=20)
    ax3.set_xlabel("clean_proj_mean")
    ax3.set_ylabel("wm_proj_mean")
    ax3.set_zlabel("att_proj_mean")
    ax3.set_title(f"Manifold (clean→wm→att) ({dataset})")
    ax3.legend(fontsize=8)
    p = out_dir / f"manifold_global_3d_{dataset}.png"
    _save(fig, p)
    saved.append(p)

    # mean Δ bars per watermark
    names = list(groups)
    fig, ax = plt.subplots(figsize=(8, 4))
    x = np.arange(len(names))
    width = 0.35
    ax.bar(x - width / 2, [_mean(_col(groups[n], "delta_wm")) for n in names], width, label="ΔWM")
    ax.bar(x + width / 2, [_mean(_col(groups[n], "delta_att")) for n in names], width, label="ΔATT")
    ax.set_xticks(x)
    ax.set_xticklabels(names, rotation=20)
    ax.set_ylabel("mean projection difference")
    ax.set_title(f"Mean Δ per watermark ({dataset})")
    ax.legend()
    p = out_dir / f"manifold_global_delta_bar_{dataset}.png"
    _save(fig, p)
    saved.append(p)
    return saved


def manifold_global_paths(out_dir: str | Path, dataset: str = "all") -> list[Path]:
    """The PNGs :func:`plot_manifold_global` writes."""
    return [Path(out_dir) / f"manifold_global_{k}_{dataset}.png" for k in ("delta", "3d", "delta_bar")]


def plot_proj_triplet(out_path: str | Path, proj_clean: np.ndarray, proj_wm: np.ndarray,
                      proj_att: np.ndarray, wm_name: str) -> None:
    """Per-file clean/wm/attacked projection trajectories."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 4))
    for sig, label in ((proj_clean, "clean"), (proj_wm, "watermarked"), (proj_att, "attacked")):
        ax.plot(np.arange(len(sig)), np.asarray(sig), label=label, alpha=0.7)
    ax.legend()
    ax.set_title(f"Projection along WM axis ({wm_name})")
    ax.set_xlabel("latent time index")
    ax.set_ylabel("projection value")
    _save(fig, out_path)


# ------------------------------------------------------------ ablation


def _order_masks(masks: list[str]) -> list[str]:
    """full_all first, then drop_last_k ascending, then keep_only_i."""
    def keyfn(m: str):
        if m == "full_all":
            return (0, 0)
        if m.startswith("drop_last_"):
            return (1, int(m.rsplit("_", 1)[1]))
        if m.startswith("keep_only_"):
            return (2, int(m.rsplit("_", 1)[1]))
        return (3, 0)

    return sorted(masks, key=keyfn)


def plot_ablation_per_wm_bars(rows: list[Row], out_dir: str | Path) -> list[Path]:
    """One bar chart per watermark: mask (ordered) vs mean score."""
    plt = _plt()
    out_dir = Path(out_dir)
    saved = []
    for wm_name, sub in _groups(rows, "watermark").items():
        means = {m: _mean(_col(r, "score")) for m, r in _groups(sub, "mask").items()}
        masks = _order_masks(list(means))
        fig, ax = plt.subplots(figsize=(10, 4))
        ax.bar(masks, [means[m] for m in masks])
        plt.setp(ax.get_xticklabels(), rotation=45, ha="right")
        ax.set_ylabel("mean score")
        ax.set_title(f"Codec layer ablation - {wm_name}")
        p = out_dir / f"snac_layer_ablation_{wm_name}.png"
        _save(fig, p)
        saved.append(p)
    return saved


# ------------------------------------------------------------ uncertainty


def plot_uncertainty_hist(rows: list[Row], out_path: str | Path, var_col: str = "mc_var_prob") -> None:
    """Variance histograms, correct vs wrong predictions."""
    plt = _plt()
    correct = _col(rows, "correct").astype(bool)
    v = _col(rows, var_col)
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(v[correct], bins=50, alpha=0.6, label="correct", density=True)
    if (~correct).any():
        ax.hist(v[~correct], bins=50, alpha=0.6, label="wrong", density=True)
    ax.set_xlabel(var_col)
    ax.set_ylabel("density")
    ax.set_title(f"{var_col}: correct vs wrong")
    ax.legend()
    _save(fig, out_path)


def plot_uncertainty_roc(rows: list[Row], out_path: str | Path, var_col: str = "mc_var_prob") -> float:
    """ROC of variance as a wrong-prediction predictor; returns the AUC."""
    plt = _plt()
    y = (~_col(rows, "correct").astype(bool)).astype(int)
    v = np.asarray(_col(rows, var_col), np.float64)
    order = np.argsort(-v)  # descending variance = most suspicious first
    y_sorted = y[order]
    tpr = np.concatenate([[0], np.cumsum(y_sorted) / max(y.sum(), 1)])
    fpr = np.concatenate([[0], np.cumsum(1 - y_sorted) / max((1 - y).sum(), 1)])
    auc = float(np.trapezoid(tpr, fpr))
    fig, ax = plt.subplots(figsize=(4, 4))
    ax.plot(fpr, tpr, label=f"AUC={auc:.3f}")
    ax.plot([0, 1], [0, 1], "k--")
    ax.set_xlabel("False Positive Rate")
    ax.set_ylabel("True Positive Rate")
    ax.set_title(f"ROC: {var_col} as uncertainty score")
    ax.legend(loc="lower right")
    _save(fig, out_path)
    return auc


def plot_reliability_curve(prob_bin, accuracy, out_path: str | Path) -> None:
    """Calibration curve from binned MC mean probs."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(4, 4))
    mask = ~np.isnan(np.asarray(accuracy, np.float64))
    ax.plot(np.asarray(prob_bin)[mask], np.asarray(accuracy)[mask], "o-")
    ax.plot([0, 1], [0, 1], "k--")
    ax.set_xlabel("predicted probability (bin mean)")
    ax.set_ylabel("empirical accuracy")
    ax.set_title("Reliability curve (MC mean prob)")
    _save(fig, out_path)


# ------------------------------------------------------------ perturbation


def plot_snr_histogram(snrs_db: np.ndarray, out_path: str | Path) -> None:
    """Watermark-residual SNR distribution."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.hist(np.asarray(snrs_db), bins=min(50, max(5, len(snrs_db) // 2)), color="skyblue", edgecolor="black")
    ax.set_title("Distribution of Watermark SNR")
    ax.set_xlabel("SNR (dB)")
    ax.set_ylabel("count")
    _save(fig, out_path)


def plot_spectral_footprint(band_energy: np.ndarray, out_path: str | Path) -> None:
    """Per-frequency-band residual-energy boxplot; `band_energy` is
    (N, n_bands)."""
    plt = _plt()
    e = 10.0 * np.log10(np.asarray(band_energy) + 1e-9)
    fig, ax = plt.subplots(figsize=(12, 6))
    ax.boxplot([e[:, i] for i in range(e.shape[1])], tick_labels=[str(i) for i in range(e.shape[1])])
    ax.set_title("Watermark Spectral Footprint (Residual Energy per Band)")
    ax.set_xlabel("Frequency Band Index (Low -> High)")
    ax.set_ylabel("Log Energy (dB)")
    _save(fig, out_path)


# ------------------------------------------------------------ PGD


def plot_detection_vs_snr(rows: list[Row], out_path: str | Path, title: str = "Attack comparison") -> None:
    """Dual-axis chart: detection-prob bars (left) and SNR line (right) per
    attack; `rows` have attack, score, snr_db."""
    plt = _plt()
    labels = [r["attack"] for r in rows]
    x = np.arange(len(labels))
    fig, ax1 = plt.subplots(figsize=(12, 6))
    ax1.bar(x - 0.175, _col(rows, "score"), 0.35, label="Detection Prob", color="skyblue", edgecolor="black")
    ax1.set_ylabel("Watermark Detection Probability", color="blue")
    ax1.set_ylim(0, 1.1)
    ax1.axhline(0.5, color="gray", linestyle="--", label="Random Guess")
    ax1.set_xticks(x)
    ax1.set_xticklabels(labels, rotation=30, ha="right")
    ax2 = ax1.twinx()
    ax2.plot(x, _col(rows, "snr_db"), color="red", marker="o", linewidth=2, label="Audio SNR (dB)")
    ax2.set_ylabel("Audio Quality (SNR dB)", color="red")
    ax1.set_title(title)
    _save(fig, out_path)


def plot_pgd_scatter(per_clip: dict[str, tuple[np.ndarray, np.ndarray]], out_path: str | Path) -> None:
    """SNR-vs-detection scatter comparing PGD variants; `per_clip` maps
    method name -> (snrs, probs) arrays."""
    plt = _plt()
    fig, ax = plt.subplots(figsize=(10, 7))
    styles = [("red", "x"), ("green", "o"), ("blue", "s"), ("orange", "^")]
    for (name, (snrs, probs)), (color, marker) in zip(per_clip.items(), styles):
        ax.scatter(np.asarray(snrs), np.asarray(probs), color=color, marker=marker,
                   label=f"{name} (avg SNR: {np.mean(snrs):.1f} dB)", alpha=0.7, s=80)
    ax.axhline(0.5, color="gray", linestyle="--", label="Random Guess (0.5)")
    ax.set_xlabel("Audio Quality (SNR dB) -> higher is better")
    ax.set_ylabel("Watermark Detection Probability -> lower is better")
    ax.set_title("Attack Comparison: Standard vs Subspace-Constrained PGD")
    ax.legend()
    ax.grid(True, alpha=0.3)
    _save(fig, out_path)


# ------------------------------------------------------------ stats


def plot_feature_importance(imp: list[Row], out_path: str | Path, target: str, top_k: int = 15) -> None:
    """The stats CLI's top-K bars of ``compute_feature_importance``'s rows
    (``nawc_tpu/cli/stats.py``'s inline plot)."""
    plt = _plt()
    top = imp[:top_k]
    fig, ax = plt.subplots(figsize=(7, max(3, 0.3 * len(top))))
    ax.barh([r["feature"] for r in top][::-1], [r["pearson"] for r in top][::-1])
    ax.set_xlabel(f"pearson correlation with {target}")
    fig.tight_layout()
    fig.savefig(out_path, dpi=100)
    plt.close(fig)
