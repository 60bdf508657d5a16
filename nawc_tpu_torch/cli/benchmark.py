"""Survivability benchmark CLI (``nawc_tpu/cli/benchmark.py``): the detector
self-check, the embed -> attack -> detect grid, or both with each method's
optimal threshold.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.benchmark --mode both \\
      --audio_glob 'data/LibriSpeech/*.wav' \\
      --watermarks spread_spectrum chunked --filecount 16 --out_dir results/

It writes ``detector_checker_results.csv`` (--mode detector),
``qwen_benchmark_results.csv`` (benchmark) or ``combined_results.csv`` and
``threshold_summary.csv`` (both) under ``--out_dir``, with the JAX CLI's
columns.  Each method runs at its native rate: the clips, loaded at
``--sample_rate``, are resampled to it (the codec-latent methods run at the
codec's 24 kHz), and so is the attack suite.  It exits with code 2 when
every row of a method is an ERROR row.  With ``--probe`` each watermark
first runs ``cli.probe`` in a disposable subprocess, on the run's clips
(the first dataset's with ``--datasets``).  --mode benchmark draws
``survival_rates.png``; ``--artifacts`` writes each clip's WAVs and
``comparison.png``.  Without matplotlib it writes the CSVs and WAVs and
prints one line naming the PNGs it did not draw.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch


def _error_only_methods(rows: list[dict], requested) -> list[str]:
    """Methods whose every result row is an ERROR row: the benchmark must
    fail loudly instead of writing error CSVs as results."""
    bad = []
    for name in requested:
        sub = [r for r in rows if r["watermark"] == name]
        if sub and all(isinstance(r.get("error"), str) for r in sub):
            print(f"[benchmark] FATAL: every row for {name!r} is an ERROR row; "
                  f"first error: {sub[0]['error']}")
            bad.append(name)
    return bad


def _mean_by(rows: list[dict], keys: tuple[str, ...], col: str) -> dict[tuple, float]:
    groups: dict[tuple, list] = {}
    for r in rows:
        if col in r:
            groups.setdefault(tuple(r[k] for k in keys), []).append(float(r[col]))
    return {k: float(np.mean(v)) for k, v in sorted(groups.items())}


def main(argv=None) -> None:
    from .common import (CODEC_SIZES, DEFAULT_AUDIO_GLOB, WM_CHOICES, build_watermarkers,
                         load_audio_batch, load_codec)

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=["benchmark", "detector", "both"], default="both")
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--data_root", default=None,
                    help="root with per-dataset subdirs of wavs; with --datasets, "
                         "runs the whole benchmark per dataset")
    ap.add_argument("--datasets", nargs="*", default=None)
    ap.add_argument("--watermarks", nargs="+", default=["spread_spectrum"], choices=WM_CHOICES)
    ap.add_argument("--filecount", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--attacks", nargs="*", default=None,
                    help="attack names (default: full suite incl. codec roundtrip)")
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=CODEC_SIZES, default="full")
    ap.add_argument("--out_dir", default="results")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--artifacts", type=int, default=0, help="save N artifact triplets")
    ap.add_argument("--probe", action="store_true",
                    help="preflight each watermark at n=2 x 1 s in a disposable "
                         "subprocess before the full-scale stage")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.probe:
        from .common import preflight_probe

        glob = (str(Path(args.data_root) / args.datasets[0] / "*.wav")
                if args.data_root and args.datasets else args.audio_glob)
        preflight_probe(args.watermarks, args.codec_ckpt, args.codec_size, args.sample_rate,
                        audio_glob=glob, device=args.device)

    from ..attacks import build_suite
    from ..dsp.resample import resample
    from ..eval import figures, run_combined, run_detector_checker, run_survivability, write_csv
    from ..eval.reporting import plot_survival_bars, save_artifacts
    from ..models.base import random_message
    from ..utils import jaxrand
    from ..utils.device import float32_parity, resolve_device

    # multi-dataset mode: once per dataset subdir, with a clean argv
    if args.data_root and args.datasets:
        for ds in args.datasets:
            print(f"\n=== dataset {ds} ===")
            child = [
                "--mode", args.mode,
                "--watermarks", *args.watermarks,
                "--filecount", str(args.filecount),
                "--seconds", str(args.seconds),
                "--sample_rate", str(args.sample_rate),
                "--codec_ckpt", args.codec_ckpt,
                "--codec_size", args.codec_size,
                "--seed", str(args.seed),
                "--artifacts", str(args.artifacts),
                "--audio_glob", str(Path(args.data_root) / ds / "*.wav"),
                "--out_dir", str(Path(args.out_dir) / ds),
                "--device", args.device,
            ]
            if args.attacks:
                child += ["--attacks", *args.attacks]
            main(child)
        return

    dev = resolve_device(args.device)
    float32_parity()
    needs_codec = any(w.startswith("semantic") for w in args.watermarks) or not args.attacks
    codec = load_codec(args.codec_ckpt, args.codec_size, device=dev) if needs_codec else None
    sr = args.sample_rate
    wav = load_audio_batch(args.audio_glob, args.filecount, sr, args.seconds).to(dev)
    wms = build_watermarkers(args.watermarks, codec, sample_rate=None if sr == 16_000 else sr,
                             device=dev)

    # each method gets audio and attacks at its own native rate
    groups: dict[int, dict[str, object]] = {}
    for name, wm in wms.items():
        groups.setdefault(wm.sample_rate, {})[name] = wm
    wav_at = {rate: wav if rate == sr else resample(wav, sr, rate) for rate in groups}

    def suite_at(rate: int) -> dict:
        suite = build_suite(rate, codec)
        return {k: suite[k] for k in args.attacks} if args.attacks else suite

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    if args.mode == "detector":
        rows = [r for rate, g in groups.items()
                for r in run_detector_checker(g, wav_at[rate], seed=args.seed, device=dev)]
        write_csv(rows, out / "detector_checker_results.csv")
        for (name,), v in _mean_by(rows, ("watermark",), "detector_works").items():
            print(f"{name}: detector_works {v:.4f}")
        if _error_only_methods(rows, wms):
            raise SystemExit(2)
    elif args.mode == "benchmark":
        rows = [r for rate, g in groups.items()
                for r in run_survivability(g, suite_at(rate), wav_at[rate], seed=args.seed, device=dev)]
        write_csv(rows, out / "qwen_benchmark_results.csv")
        if figures.available():
            plot_survival_bars(rows, out / "survival_rates.png")
        else:
            figures.not_drawn([out / "survival_rates.png"])
        ok = [r for r in rows if r["clip_index"] >= 0]
        for (name, attack), v in _mean_by(ok, ("watermark", "attack"), "survived").items():
            print(f"{name} {attack}: survived {v:.4f}")
        if _error_only_methods(rows, wms):
            raise SystemExit(2)
    else:
        per_method, summary = [], []
        for rate, g in groups.items():
            rep = run_combined(g, suite_at(rate), wav_at[rate], seed=args.seed, device=dev)
            per_method += rep.per_method
            summary += rep.summary
        write_csv(per_method, out / "combined_results.csv")
        write_csv(summary, out / "threshold_summary.csv")
        for r in summary:
            print(" ".join(f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}" for k, v in r.items()))
        if _error_only_methods(per_method, wms):
            raise SystemExit(2)

    if args.artifacts:
        key = jaxrand.prng_key(args.seed)
        name, wm = next(iter(wms.items()))
        wav_a = wav_at[wm.sample_rate]  # artifacts at the method's native rate
        attack = next(iter(build_suite(wm.sample_rate, codec).values()))
        with torch.no_grad():
            if getattr(wm, "n_bits", 0) > 0:
                msg = random_message(key, wav_a.shape[0], wm.n_bits, device=dev)
                marked = wm.embed(wav_a, msg, key)
            else:
                marked = wm.embed(wav_a)
            attacked = attack(marked, key)
        n_art = min(args.artifacts, wav_a.shape[0])
        for i in range(n_art):
            save_artifacts(out / "artifacts", f"{name}_{i}", *(
                x[i].cpu().numpy() for x in (wav_a, marked, attacked)), wm.sample_rate)
        if not figures.available():
            figures.not_drawn([out / "artifacts" / f"{name}_{i}" / "comparison.png" for i in range(n_art)])


if __name__ == "__main__":
    main()
