"""Adversarially fine-tune the codec decoder (MPD/MSD GAN; encoder frozen).

Usage:
  python -m nawc_tpu_torch.cli.train_gan --resume checkpoints/codec_24k.msgpack \
      --steps 8000 --batch 16 --out checkpoints/codec_24k_gan.msgpack

The flags and defaults of ``nawc_tpu.cli.train_gan``, plus ``--device``
(default cuda); float32 with TF32 off.  The checkpoint is the JAX CLI's
flax tree, and the ``.log.jsonl`` lines carry the same keys.
"""

from __future__ import annotations

import argparse
import glob
import json
import time
from pathlib import Path

import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio_glob", default="data/LibriSpeech/*.wav")
    ap.add_argument("--steps", type=int, default=8_000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=32_768 / 24_000)
    ap.add_argument("--g_lr", type=float, default=1e-4)
    ap.add_argument("--d_lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--resume", default="checkpoints/codec_24k.msgpack",
                    help="codec checkpoint to fine-tune (required in practice)")
    ap.add_argument("--out", default="checkpoints/codec_24k_gan.msgpack")
    ap.add_argument("--sisnr_weight", type=float, default=0.05)
    ap.add_argument("--adv_weight", type=float, default=1.0)
    ap.add_argument("--fm_weight", type=float, default=2.0)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--val_files", type=int, default=8,
                    help="hold out the last N files; eval si-snr/lsd/stoi every save_every")
    ap.add_argument("--size", choices=["full", "small"], default="full")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..codec.convert import state_dict_to_flax
    from ..train.adversarial import decoder_only_tx, init_discriminators, make_gan_train_step
    from ..train.codec_train import make_codec_eval_fn, speech_batches, trainable_codec
    from ..train.optim import AdamW
    from ..utils.checkpoint import load_params, save_params
    from ..utils.config import CodecConfig
    from ..utils.device import float32_parity, resolve_device

    dev = resolve_device(args.device)
    float32_parity()
    if args.size == "full":
        cfg = CodecConfig()
    else:
        cfg = CodecConfig(encoder_dim=8, latent_dim=64, decoder_dim=64,
                          codebook_size=128, codebook_dim=8)

    files = sorted(glob.glob(args.audio_glob))
    if not files:
        raise SystemExit(f"no audio files match {args.audio_glob}")
    val_files: list[str] = []
    if args.val_files:
        val_files, files = files[-args.val_files:], files[: -args.val_files]

    t = int(args.seconds * cfg.sample_rate) // cfg.chunk * cfg.chunk or cfg.chunk
    codec = trainable_codec(cfg, args.seed, dev, tree=load_params(args.resume) if args.resume else None)
    if args.resume:
        print(f"[train_gan] resumed codec from {args.resume}", flush=True)
    disc = init_discriminators(args.seed + 1, dev)
    n_disc = sum(p.numel() for p in disc.parameters())
    print(f"[train_gan] discriminators: {n_disc/1e6:.2f}M params; "
          f"decoder-only generator grads", flush=True)

    g_opt = decoder_only_tx(codec, lr=args.g_lr, b1=0.8, b2=0.99, weight_decay=1e-4)
    d_opt = AdamW(disc.parameters(), args.d_lr, b1=0.8, b2=0.99, weight_decay=1e-4)
    step_fn = make_gan_train_step(cfg, sisnr_weight=args.sisnr_weight,
                                  adv_weight=args.adv_weight, fm_weight=args.fm_weight)
    batches = speech_batches(files, args.batch, t / cfg.sample_rate, cfg.sample_rate, seed=args.seed)

    eval_fn = None
    val_batch = None
    if val_files:
        eval_fn = make_codec_eval_fn(cfg)
        val_batch = torch.from_numpy(next(speech_batches(
            val_files, min(4 * args.batch, 64), t / cfg.sample_rate,
            cfg.sample_rate, seed=args.seed + 1, loop=False))[:, :t]).to(dev)

    out_path = Path(args.out)
    log_path = out_path.with_suffix(".log.jsonl")
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t_start = time.time()
    for step in range(1, args.steps + 1):
        wav = torch.from_numpy(next(batches)[:, :t]).to(dev)
        metrics = step_fn(codec, disc, g_opt, d_opt, wav)
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in sorted(metrics.items())}
            if eval_fn is not None and step % args.save_every == 0:
                m.update({k: float(v) for k, v in sorted(eval_fn(codec, val_batch).items())})
            m.update(step=step, wall=round(time.time() - t_start, 1))
            print(f"[train_gan] {json.dumps(m)}", flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(m) + "\n")
        if step % args.save_every == 0 or step == args.steps:
            save_params(out_path, state_dict_to_flax(codec))
            print(f"[train_gan] saved {out_path} @ step {step}", flush=True)


if __name__ == "__main__":
    main()
