"""MC-uncertainty CLI (``nawc_tpu/cli/uncertainty.py``): 20 noisy detector
passes per clip (marked and clean), variance vs error analysis,
calibration.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.uncertainty --watermark spread_spectrum --filecount 16

It writes ``uncertainty_results.csv`` and ``reliability_curve.csv`` under
``--out_dir``, with the JAX CLI's columns, and prints the accuracy, the
variance-error AUC and the ECE.  It draws the variance box plots, the
correct-vs-wrong histogram, the ROC and the reliability curve.
Without matplotlib it writes the CSVs and prints one line naming the
PNGs it did not draw.
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None) -> None:
    from .common import (CODEC_SIZES, DEFAULT_AUDIO_GLOB, WM_CHOICES, build_watermarkers,
                         load_audio_batch, load_codec)

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--watermark", default="spread_spectrum", choices=WM_CHOICES)
    ap.add_argument("--filecount", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--mc_samples", type=int, default=20)
    ap.add_argument("--noise_sigma", type=float, default=1e-3)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_dir", default="results/uncertainty")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..eval import figures
    from ..eval.reporting import plot_variance_boxplots
    from ..eval.robustness import write_csv
    from ..interp import expected_calibration_error, mc_statistics, reliability_curve, variance_error_auc
    from ..models.base import embed_payload
    from ..utils import jaxrand
    from ..utils.device import float32_parity, resolve_device

    dev = resolve_device(args.device)
    float32_parity()
    codec = (load_codec(args.codec_ckpt, args.codec_size, device=dev)
             if args.watermark.startswith("semantic") else None)
    wav = load_audio_batch(args.audio_glob, args.filecount, args.sample_rate, args.seconds).to(dev)
    wm = build_watermarkers([args.watermark], codec, device=dev,
                            sample_rate=None if args.sample_rate == 16_000 else args.sample_rate
                            )[args.watermark]
    with torch.no_grad():
        marked, _ = embed_payload(wm, wav, jaxrand.prng_key(0))
        both = torch.cat([marked, wav])
        labels = np.concatenate([np.ones(wav.shape[0]), np.zeros(wav.shape[0])]).astype(np.int32)
        stats = mc_statistics(wm.score, both, jaxrand.prng_key(1), labels=labels,
                              n_samples=args.mc_samples, sigma=args.noise_sigma)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    cols = {**stats, "label": labels}
    rows = [{k: v[i] for k, v in cols.items()} for i in range(len(labels))]
    write_csv(rows, out / "uncertainty_results.csv")
    auc = variance_error_auc(stats["mc_var_prob"], stats["correct"])
    ece = expected_calibration_error(stats["mc_mean_prob"], labels)
    c, a, n = reliability_curve(stats["mc_mean_prob"], labels)
    write_csv([{"prob_bin": c[i], "accuracy": a[i], "count": n[i]} for i in range(len(c))],
              out / "reliability_curve.csv")
    pngs = [out / name for name in ("variance_boxplots.png", "mc_var_prob_correct_vs_wrong_hist.png",
                                    "mc_var_prob_roc.png", "reliability_curve_mc_mean_prob.png")]
    if figures.available():
        grouped = [{**r, "group": "marked" if r["label"] == 1 else "clean"} for r in rows]
        plot_variance_boxplots(grouped, pngs[0], group_col="group")
        figures.plot_uncertainty_hist(grouped, pngs[1])
        figures.plot_uncertainty_roc(grouped, pngs[2])
        figures.plot_reliability_curve(c, a, pngs[3])
    else:
        figures.not_drawn(pngs)
    print(f"accuracy={stats['correct'].mean():.3f} var_error_auc={auc:.3f} ece={ece:.3f}")


if __name__ == "__main__":
    main()
