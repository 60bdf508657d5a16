"""PGD and latent-PCA research CLI (``nawc_tpu/cli/pgd.py``).

Modes:
  attack      plain sign-PGD against the watermark score
  baselines   DSP and PCA latent attacks compared
  exp_a       the watermark's latent-delta metrics
  exp_b       the PCA reconstruction-attack K-sweep
  exp_c       standard against subspace-protected PGD
  interp      PGD and the head/tail PCA energy split of its latent change

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.pgd --mode exp_b --filecount 8

Each mode writes the JAX CLI's CSVs, with its columns, under ``--out_dir``.
baselines draws ``benchmark_chart.png`` and exp_c
``experiment_c_results.png``; without matplotlib a mode prints one line
naming the PNG it did not draw.  The PCA is fitted on the device, so its
components' signs are cuSOLVER's on the card (ROADMAP.md C).
"""

from __future__ import annotations

import argparse
from pathlib import Path

MODES = ("attack", "baselines", "exp_a", "exp_b", "exp_c", "interp")


def main(argv=None) -> None:
    from .common import DEFAULT_AUDIO_GLOB, build_watermarkers, load_audio_batch, load_codec

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mode", choices=MODES, default="attack")
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--watermark", default="spread_spectrum")
    ap.add_argument("--filecount", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--eps", type=float, default=0.02)
    ap.add_argument("--lr", type=float, default=0.001)
    ap.add_argument("--pca_components", type=int, default=128)
    ap.add_argument("--head_k", type=int, default=60)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=["full", "small"], default="full")
    ap.add_argument("--out_dir", default="results/pgd")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..attacks import latent_transform_attack, pgd_attack, subspace_pgd_attack
    from ..eval import figures
    from ..eval.metrics import si_snr
    from ..eval.robustness import write_csv
    from ..interp import agg_stats, get_latent
    from ..interp.latent_pca import (
        amputation_fn,
        fit_pca,
        head_tail_energy,
        jamming_fn,
        latent_delta_metrics,
        reconstruction_attack_sweep,
        rounding_fn,
    )
    from ..models.base import embed_payload
    from ..ops import jaxrand as keyed
    from ..utils import jaxrand
    from ..utils.device import float32_parity, resolve_device
    from .robustness import format_table

    dev = resolve_device(args.device)
    float32_parity()
    codec = load_codec(args.codec_ckpt, args.codec_size, device=dev)
    wav = load_audio_batch(args.audio_glob, args.filecount, args.sample_rate, args.seconds).to(dev)
    wm = build_watermarkers([args.watermark], codec, device=dev,
                            sample_rate=None if args.sample_rate == 16_000 else args.sample_rate
                            )[args.watermark]

    key = jaxrand.prng_key(0)
    with torch.no_grad():
        marked, msg = embed_payload(wm, wav, key)

    # white-box attacks need gradients: prefer a differentiable soft score
    # (the chunked watermark's 1-BER score is a step function)
    score_attr = getattr(wm, "score_soft", wm.score)

    def score_fn(w):
        return score_attr(w, msg) if msg is not None else score_attr(w)

    def latent_fn(w):
        return get_latent(codec, w)

    def host(x) -> np.ndarray:
        return x.detach().cpu().numpy()

    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)

    def pca():
        with torch.no_grad():
            return fit_pca(latent_fn(wav), args.pca_components)

    if args.mode == "attack":
        attacked = pgd_attack(score_fn, marked, steps=args.steps, eps=args.eps, lr=args.lr)
        with torch.no_grad():
            cols = {"score_before": host(score_fn(marked)), "score_after": host(score_fn(attacked)),
                    "snr_db": host(si_snr(marked, attacked))}
        write_csv([{k: v[i] for k, v in cols.items()} for i in range(wav.shape[0])], out / "pgd_attack.csv")
        print("\n".join(f"{k} {float(v.mean()):.6g}" for k, v in cols.items()))

    elif args.mode == "baselines":
        mean, comps, _ = pca()
        noise = keyed.normal(key, marked.shape, dev)
        attacks = {
            "clean": lambda w: w,
            "gaussian_noise": lambda w: w + 0.003 * noise,
            "pca_amputation": lambda w: latent_transform_attack(codec, w, amputation_fn(mean, comps, args.head_k)),
            "pca_jamming": lambda w: latent_transform_attack(codec, w, jamming_fn(mean, comps, args.head_k, key)),
            "latent_rounding": lambda w: latent_transform_attack(codec, w, rounding_fn(5.0)),
        }
        rows = []
        with torch.no_grad():
            for name, fn in attacks.items():
                att = fn(marked)
                rows.append({"attack": name, "score": float(host(score_fn(att)).mean()),
                             "snr_db": float(host(si_snr(marked, att)).mean())})
        write_csv(rows, out / "attack_baselines.csv")
        if figures.available():
            figures.plot_detection_vs_snr(
                rows, out / "benchmark_chart.png",
                title=f"Comparison: Subspace Attacks vs Baselines (K={args.head_k})")
        else:
            figures.not_drawn([out / "benchmark_chart.png"])
        print(format_table(rows, "attack", ("score", "snr_db"), digits=6))

    elif args.mode == "exp_a":
        with torch.no_grad():
            m = latent_delta_metrics(latent_fn(wav), latent_fn(marked))
        per_clip = [k for k in m if k != "pca_cumvar"]
        write_csv([{k: m[k][i] for k in per_clip} for i in range(wav.shape[0])], out / "exp_a_metrics.csv")
        write_csv([{"pca_cumvar": v} for v in m["pca_cumvar"]], out / "exp_a_cumvar.csv")
        print({k: float(np.mean(v)) for k, v in m.items()})

    elif args.mode == "exp_b":
        mean, comps, _ = pca()
        ks = [k for k in (10, 20, 50, 80, 100, args.pca_components) if k <= args.pca_components]
        rows = reconstruction_attack_sweep(codec, wm, marked, mean, comps, ks, msg)
        write_csv(rows, out / "exp_b_reconstruction.csv")
        print(format_table(rows, "keep_k", ("score_mean", "sisnr_mean"), digits=6))

    elif args.mode == "exp_c":
        _, comps, _ = pca()
        std = pgd_attack(score_fn, marked, steps=args.steps, eps=args.eps, lr=args.lr)
        sub = subspace_pgd_attack(score_fn, latent_fn, marked, comps[: args.head_k],
                                  steps=args.steps, eps=args.eps, lr=args.lr)
        with torch.no_grad():
            per_clip = {method: (host(si_snr(marked, att)), host(score_fn(att)))
                        for method, att in (("standard_pgd", std), ("subspace_pgd", sub))}
        rows = [{"method": method, "clip": i, "snr_db": float(s[i]), "score": float(p[i])}
                for method, (s, p) in per_clip.items() for i in range(len(s))]
        write_csv(rows, out / "exp_c_comparison.csv")
        if figures.available():
            figures.plot_pgd_scatter(per_clip, out / "experiment_c_results.png")
        else:
            figures.not_drawn([out / "experiment_c_results.png"])
        means = agg_stats([{k: r[k] for k in ("method", "score", "snr_db")} for r in rows], ["method"])
        print(format_table(means, "method", ("score_mean", "snr_db_mean"), digits=6))

    else:  # interp
        _, comps, _ = pca()
        attacked = pgd_attack(score_fn, marked, steps=args.steps, eps=args.eps, lr=args.lr)
        with torch.no_grad():
            dz = latent_fn(attacked) - latent_fn(marked)
        head, tail = head_tail_energy(dz, comps, args.head_k)
        rows = [{"head_energy": head, "tail_energy": tail, "head_fraction": head / (head + tail + 1e-12)}]
        write_csv(rows, out / "pgd_interpretability.csv")
        print(format_table(rows, "head_energy", ("tail_energy", "head_fraction"), digits=6))


if __name__ == "__main__":
    main()
