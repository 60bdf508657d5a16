"""Audio-quality evaluation CLI (``nawc_tpu/cli/quality.py``; the
reference's ``audio_quality_check/evaluate_quality.py`` + ``make_pairs.py``).

Three modes:
  * --results_dir: walk an artifact tree pairing 1_original/2_watermarked wavs
  * --watermark: embed on the fly and evaluate
  * --summarize_dir: one row per method of <dir>/*_quality_results.csv

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.quality --watermark spread_spectrum --filecount 16

The first two write ``--out_csv`` with the reference's quality-results
columns and print the mean of each numeric column; the third writes
``quality_summary.csv`` in the directory.  SNR, SI-SNR, LSD and the
approximate STOI run on the device, exact STOI and PESQ (the ITU package
when it imports, else the calibrated proxy: see the ``pesq_impl`` column)
on the host.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import numpy as np
import torch


def _mean(values) -> float:
    """The mean of the numbers that are not NaN (NaN when none is), as
    pandas' ``Series.mean`` takes it."""
    vals = np.asarray([v for v in values if not math.isnan(v)], np.float64)
    return float(vals.sum() / vals.size) if vals.size else math.nan


def summarize_quality_dir(dir_: str) -> None:
    """<dir>/*_quality_results.csv -> quality_summary.csv with one row per
    method: SI-SNR wm / SNR / LSD / PESQ / STOI means (the shape of the
    reference's ``audio_quality_check`` tables)."""
    from ..eval.metrics import pesq_impl
    from ..eval.robustness import write_csv
    from .robustness import format_table
    from .stats import load_table

    def col(rows, name):
        return _mean([r[name] for r in rows]) if rows and name in rows[0] else math.nan

    out = []
    for p in sorted(Path(dir_).glob("*_quality_results.csv")):
        rows = load_table(str(p))
        out.append({
            "method": p.name.replace("_quality_results.csv", ""),
            "n_pairs": len(rows),
            "si_snr_wm_db": col(rows, "si_snr_watermarked"),
            "snr_db": col(rows, "snr"),
            "lsd": col(rows, "lsd"),
            "pesq": col(rows, "pesq"),
            "stoi": col(rows, "stoi"),
            "lsd_native_sr": col(rows, "lsd_native"),
            "pesq_impl": pesq_impl(),
        })
    if not out:
        raise SystemExit(f"no *_quality_results.csv under {dir_}")
    out_path = Path(dir_) / "quality_summary.csv"
    write_csv(out, out_path)
    print(format_table(out, "method", ("n_pairs", "si_snr_wm_db", "snr_db", "lsd", "pesq", "stoi",
                                       "lsd_native_sr"), digits=6))
    print(f"pesq_impl: {out[0]['pesq_impl']}")
    print(f"wrote {out_path}")


def embed_batched(wm, wav: torch.Tensor, msg: torch.Tensor | None, key, batch: int) -> torch.Tensor:
    """`wm`'s embed of `wav` in sub-batches of `batch` clips, the tail
    padded by repeating its last clip (and message) so that every call has
    the same shape."""
    bsz = max(1, min(batch, wav.shape[0]))
    parts = []
    for i in range(0, wav.shape[0], bsz):
        w = wav[i:i + bsz]
        pad = bsz - w.shape[0]
        w = torch.cat([w, w[-1:].repeat(pad, 1)]) if pad else w
        if msg is not None:
            m = msg[i:i + bsz]
            m = torch.cat([m, m[-1:].repeat(pad, 1)]) if pad else m
            mk = wm.embed(w, m, key)
        else:
            mk = wm.embed(w)
        parts.append(mk[:bsz - pad])
    return torch.cat(parts)


def main(argv=None) -> None:
    from .common import (CODEC_SIZES, DEFAULT_AUDIO_GLOB, WM_CHOICES, build_watermarkers,
                         load_audio_batch, load_codec)

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--results_dir", default=None, help="artifact tree with wav pairs")
    ap.add_argument("--watermark", default=None, choices=WM_CHOICES)
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--filecount", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_csv", default="results/quality_results.csv")
    ap.add_argument("--embed_batch", type=int, default=16,
                    help="embed sub-batch size: the semantic Adam-PGD embed holds "
                         "STFTs and optimiser state for the whole batch in device "
                         "memory; sub-batches keep it flat")
    ap.add_argument("--summarize_dir", default=None,
                    help="aggregate <dir>/*_quality_results.csv into a per-method "
                         "summary table, then exit")
    ap.add_argument("--probe", action="store_true",
                    help="preflight the watermark at n=2 x 1 s in a disposable "
                         "subprocess before the full-scale embed")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.probe and args.watermark:
        from .common import preflight_probe

        preflight_probe([args.watermark], args.codec_ckpt, args.codec_size, args.sample_rate,
                        audio_glob=args.audio_glob, device=args.device)

    if args.summarize_dir:
        summarize_quality_dir(args.summarize_dir)
        return

    from ..eval import evaluate_pair_batch, evaluate_pairs, make_pairs, write_csv
    from ..models.base import random_message
    from ..utils import jaxrand
    from ..utils.device import float32_parity, resolve_device

    dev = resolve_device(args.device)
    float32_parity()
    Path(args.out_csv).parent.mkdir(parents=True, exist_ok=True)
    if args.results_dir:
        pairs = make_pairs(args.results_dir)
        if not pairs:
            raise SystemExit(f"no wav pairs under {args.results_dir}")
        rows = evaluate_pairs(pairs, sr=args.sample_rate, device=dev)
    elif args.watermark:
        needs_codec = args.watermark.startswith("semantic") or args.watermark == "token_green"
        codec = load_codec(args.codec_ckpt, args.codec_size, device=dev) if needs_codec else None
        wm = build_watermarkers([args.watermark], codec,
                                sample_rate=None if args.sample_rate == 16_000 else args.sample_rate,
                                device=dev)[args.watermark]
        # embed at the method's NATIVE rate: only the quality measurement
        # resamples to 16 kHz (evaluate_quality.py:20-27)
        wav = load_audio_batch(args.audio_glob, args.filecount, wm.sample_rate, args.seconds).to(dev)
        key = jaxrand.prng_key(0)
        msg = random_message(key, wav.shape[0], wm.n_bits, device=dev) if getattr(wm, "n_bits", 0) > 0 else None
        with torch.no_grad():
            marked = embed_batched(wm, wav, msg, key, args.embed_batch)
        cols = evaluate_pair_batch(wav, marked, wm.sample_rate, with_pesq=True)
        # numpy scalars, so that the CSV writes the float32 device columns
        # in float32's shortest form, as pandas does
        rows = [{"clean": f"clip_{i}", "watermarked": args.watermark, "attack": "",
                 "instrument": "speech", **{k: v[i] for k, v in cols.items()}}
                for i in range(wav.shape[0])]
    else:
        raise SystemExit("need --results_dir or --watermark")

    write_csv(rows, args.out_csv)
    for k, v in rows[0].items():
        if not isinstance(v, str):
            print(f"{k:20s} {_mean([float(r[k]) for r in rows]):.6f}")


if __name__ == "__main__":
    main()
