"""Watermark-residual spectral analysis CLI (``nawc_tpu/cli/perturbation.py``):
residual wm - clean -> per-clip SNR and per-band spectral footprint.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.perturbation --watermark spread_spectrum --filecount 16

It writes ``perturbation_analysis.csv`` under ``--out_dir``, with the JAX
CLI's columns, and draws ``snr_histogram.png`` and
``spectral_footprint.png``.  Without matplotlib it writes the CSV and
prints one line naming the PNGs it did not draw.
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
    ap.add_argument("--n_bands", type=int, default=16)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_dir", default="results/perturbation")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from ..eval import figures
    from ..eval.robustness import write_csv
    from ..interp import residual_report
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
        rep = residual_report(wav, marked, n_bands=args.n_bands)
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    band = rep["band_energy"]
    write_csv([{"clip": i, "snr_db": rep["snr_db"][i],
                **{f"band_{j}_energy": band[i, j] for j in range(band.shape[1])}}
               for i in range(wav.shape[0])], out / "perturbation_analysis.csv")
    pngs = [out / "snr_histogram.png", out / "spectral_footprint.png"]
    if figures.available():
        figures.plot_snr_histogram(rep["snr_db"], pngs[0])
        figures.plot_spectral_footprint(band, pngs[1])
    else:
        figures.not_drawn(pngs)
    print(f"snr_db mean={rep['snr_db'].mean():.2f} -> {out}")


if __name__ == "__main__":
    main()
