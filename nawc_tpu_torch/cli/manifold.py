"""Manifold analysis CLI (``nawc_tpu/cli/manifold.py``): latent-axis
projections of the clean / watermarked / codec-round-tripped triplet for
each watermark, at the codec's rate.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.manifold --watermarks spread_spectrum semantic_cluster \\
      --filecount 8 --out_dir results/manifold

It writes ``manifold_analysis.csv`` under ``--out_dir``, with the JAX CLI's
columns, prints the per-watermark means, and draws the per-clip triplet
plots under ``plots/<wm>/`` and the three ``manifold_global_*_all.png``.
Without matplotlib it writes the CSVs and prints one line naming the
PNGs it did not draw.
"""

from __future__ import annotations

import argparse
from pathlib import Path

_PRINTED = ("delta_wm", "delta_att", "score_wm", "score_att")


def main(argv=None) -> None:
    from .common import (CODEC_SIZES, DEFAULT_AUDIO_GLOB, WM_CHOICES, build_watermarkers,
                         load_audio_batch, load_codec)

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--watermarks", nargs="+", default=["spread_spectrum"], choices=WM_CHOICES)
    ap.add_argument("--filecount", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_dir", default="results/manifold")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..attacks import codec_roundtrip
    from ..eval import figures
    from ..eval.robustness import write_csv
    from ..interp import agg_stats, run_manifold_analysis
    from ..interp.manifold import triplet_paths
    from ..models import at_rate
    from ..utils.device import float32_parity, resolve_device
    from .robustness import format_table

    dev = resolve_device(args.device)
    float32_parity()
    codec = load_codec(args.codec_ckpt, args.codec_size, device=dev)
    sr = codec.cfg.sample_rate
    wav = load_audio_batch(args.audio_glob, args.filecount, sr, args.seconds).to(dev)
    # the fixed-rate methods join the analysis through the resampling adapter
    wms = {n: at_rate(w, sr)
           for n, w in build_watermarkers(args.watermarks, codec, sample_rate=sr, device=dev).items()}

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    draw = figures.available()
    rows = run_manifold_analysis(codec, wms, wav, lambda w: codec_roundtrip(codec, w),
                                 triplet_dir=out / "plots" if draw else None)
    write_csv(rows, out / "manifold_analysis.csv")
    if draw:
        for p in figures.plot_manifold_global(rows, out):
            print(f"saved {p}")
    else:
        figures.not_drawn([p for n in wms for p in triplet_paths(out / "plots", n, wav.shape[0])]
                          + figures.manifold_global_paths(out))
    means = agg_stats([{k: r[k] for k in ("watermark",) + _PRINTED} for r in rows], ["watermark"])
    print(format_table(means, "watermark", tuple(f"{c}_mean" for c in _PRINTED), digits=6))


if __name__ == "__main__":
    main()
