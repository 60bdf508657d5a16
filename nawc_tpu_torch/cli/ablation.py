"""Codebook-layer ablation CLI (``nawc_tpu/cli/ablation.py``): every
watermark re-detected after the codec round-trip with RVQ levels masked.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.ablation --watermarks spread_spectrum --filecount 8

It writes ``layer_ablation.csv`` under ``--out_dir``, with the JAX CLI's
columns, prints the (mask x watermark) table of mean scores, and draws
``ablation_heatmap.png`` and ``snac_layer_ablation_<wm>.png``.
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
    ap.add_argument("--watermarks", nargs="+", default=["spread_spectrum"], choices=WM_CHOICES)
    ap.add_argument("--filecount", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_dir", default="results/ablation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..eval import figures
    from ..eval.reporting import plot_ablation_heatmap
    from ..eval.robustness import write_csv
    from ..interp import ablation_heatmap, run_layer_ablation
    from ..models import at_rate
    from ..utils.device import float32_parity, resolve_device
    from .robustness import format_table

    dev = resolve_device(args.device)
    float32_parity()
    codec = load_codec(args.codec_ckpt, args.codec_size, device=dev)
    wav = load_audio_batch(args.audio_glob, args.filecount, args.sample_rate, args.seconds).to(dev)
    # the fixed-rate methods join through the resampling adapter, so that
    # one ablation grid covers every family at one rate
    wms = {n: at_rate(w, args.sample_rate)
           for n, w in build_watermarkers(
               args.watermarks, codec, device=dev,
               sample_rate=None if args.sample_rate == 16_000 else args.sample_rate).items()}

    rows = run_layer_ablation(codec, wms, wav, in_sr=args.sample_rate)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    write_csv(rows, out / "layer_ablation.csv")
    pngs = [out / "ablation_heatmap.png", *(out / f"snac_layer_ablation_{w}.png" for w in sorted(wms))]
    if figures.available():
        plot_ablation_heatmap(rows, pngs[0])
        for p in figures.plot_ablation_per_wm_bars(rows, out):
            print(f"saved {p}")
    else:
        figures.not_drawn(pngs)
    print(format_table(ablation_heatmap(rows), "mask", tuple(sorted(wms)), digits=6))


if __name__ == "__main__":
    main()
