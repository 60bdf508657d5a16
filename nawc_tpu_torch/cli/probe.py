"""Tiny-scale end-to-end probe (``nawc_tpu/cli/probe.py``): embed + detect
for one watermark at n=2 x 1 s clips, printing one OK line.

Run in a disposable subprocess before a full-scale stage
(``cli.common.preflight_probe``, the benchmark CLI's ``--probe``): a path
that hangs or dies fails there, at a scale that cannot hurt, before the
full-scale run.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.probe --watermark semantic_cluster
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    from .common import DEFAULT_AUDIO_GLOB, WM_CHOICES, build_watermarkers, load_audio_batch, load_codec

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--watermark", required=True, choices=WM_CHOICES)
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--filecount", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--sample_rate", type=int, default=16_000)
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=["full", "small"], default="full")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from ..models.base import embed_payload
    from ..utils import jaxrand
    from ..utils.device import float32_parity, resolve_device

    dev = resolve_device(args.device)
    float32_parity()
    needs_codec = args.watermark.startswith("semantic") or args.watermark == "token_green"
    codec = load_codec(args.codec_ckpt, args.codec_size, device=dev) if needs_codec else None
    wm = build_watermarkers(
        [args.watermark], codec,
        sample_rate=None if args.sample_rate == 16_000 else args.sample_rate, device=dev,
    )[args.watermark]
    wav = load_audio_batch(args.audio_glob, args.filecount, wm.sample_rate, args.seconds).to(dev)
    with torch.no_grad():
        marked, _ = embed_payload(wm, wav, jaxrand.prng_key(0))
        presence, _bits = wm.detect(marked)
    presence = presence.cpu().numpy()
    if not np.isfinite(presence).all():
        raise SystemExit(f"probe {args.watermark}: presence not finite: {presence}")
    print(f"probe ok {args.watermark} n={wav.shape[0]} "
          f"presence={np.round(presence.mean(), 4)}", flush=True)


if __name__ == "__main__":
    main()
