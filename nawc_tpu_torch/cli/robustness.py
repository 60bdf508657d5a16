"""Robustness sweep CLI (``nawc_tpu/cli/robustness.py``): per-chunk results
with the raw_bench schema, then overall and per-attack stats.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.robustness --watermark spread_spectrum
      --audio_glob 'data/LibriSpeech/*.wav' --filecount 16 --out_dir results/robustness

It writes ``shards/<attack>.csv``, ``test_results.csv`` (pipe-delimited),
``overall_stats.csv`` and ``stats_by_attack.csv`` under ``--out_dir``, and
draws the box plot of SI-SNR by attack, ``sisnr_by_attack.png``.
Without matplotlib it writes the CSVs and prints one line naming the
PNGs it did not draw.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

_TABLE_COLS = ("bitwise/clean_mean", "bitwise/distorted_mean", "hard/clean_mean",
               "hard/distorted_mean", "sisnr_wm_mean")


def format_table(rows: list[dict], index: str, cols: tuple[str, ...], digits: int = 3) -> str:
    """The rows as a right-aligned text table indexed by `index`, values
    rounded to `digits`."""
    def cell(v):
        return "NaN" if isinstance(v, float) and math.isnan(v) else f"{round(v, digits):g}"

    body = [[str(r[index])] + [cell(r[c]) for c in cols] for r in rows]
    head = [index] + list(cols)
    widths = [max(len(x) for x in col) for col in zip(head, *body)]
    lines = [" ".join(h.ljust(w) if i == 0 else h.rjust(w)
                      for i, (h, w) in enumerate(zip(head, widths)))]
    for line in body:
        lines.append(" ".join(x.ljust(w) if i == 0 else x.rjust(w)
                              for i, (x, w) in enumerate(zip(line, widths))))
    return "\n".join(lines)


def main(argv=None) -> None:
    from .common import (CODEC_SIZES, DEFAULT_AUDIO_GLOB, WM_CHOICES, build_watermarkers,
                         load_audio_clips, load_codec)

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--watermark", default="spread_spectrum", choices=WM_CHOICES)
    ap.add_argument("--filecount", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--chunk_seconds", type=float, default=2.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_dir", default="results/robustness")
    ap.add_argument("--sync", action="store_true",
                    help="use shift-robust sync detection when the watermark supports it")
    ap.add_argument("--detect_batch", type=int, default=None,
                    help="detect in sub-batches of this many chunks (bounds peak memory)")
    ap.add_argument("--resume", action="store_true",
                    help="skip attacks whose per-attack shard CSV already exists")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..attacks import build_suite
    from ..eval import (figures, overall_stats, read_csv, run_robustness, stats_by_attack, write_csv,
                        write_results_csv)
    from ..eval.reporting import plot_metric_boxplots

    codec = load_codec(args.codec_ckpt, args.codec_size, device=args.device)
    clips = load_audio_clips(args.audio_glob, args.filecount, args.sample_rate, args.seconds)
    sr = None if args.sample_rate == 16_000 else args.sample_rate
    wm = build_watermarkers([args.watermark], codec, sample_rate=sr, device=args.device)[args.watermark]
    suite = build_suite(args.sample_rate, codec)
    suite.pop("identity", None)
    out = Path(args.out_dir)
    shard_dir = out / "shards"
    shard_dir.mkdir(parents=True, exist_ok=True)

    # one shard file per attack, so that a killed sweep resumes where it stopped
    rows: list[dict] = []
    for aname, afn in suite.items():
        shard = shard_dir / f"{aname}.csv"
        if args.resume and shard.exists():
            rows += read_csv(shard)
            continue
        part = run_robustness(wm, {aname: afn}, clips, args.sample_rate, args.chunk_seconds,
                              sync=args.sync, detect_batch=args.detect_batch, device=args.device)
        write_csv(part, shard)
        rows += part
    write_results_csv(rows, out / "test_results.csv")
    write_csv(overall_stats(rows), out / "overall_stats.csv")
    by_attack = stats_by_attack(rows)
    write_csv(by_attack, out / "stats_by_attack.csv")
    if figures.available():
        plot_metric_boxplots(rows, out / "sisnr_by_attack.png", metric_col="sisnr_attack")
    else:
        figures.not_drawn([out / "sisnr_by_attack.png"])
    print(format_table(by_attack, "attack_type", _TABLE_COLS))


if __name__ == "__main__":
    main()
