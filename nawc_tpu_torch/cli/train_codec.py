"""Train the SNAC-style codec.

Usage:
  python -m nawc_tpu_torch.cli.train_codec --audio_glob 'data/LibriSpeech/*.wav' \
      --steps 20000 --batch 16 --seconds 1.3653 --out checkpoints/codec_24k.msgpack

The flags and defaults of ``nawc_tpu.cli.train_codec`` (``--cfg.<field>``
overrides included), plus ``--device`` (default cuda); float32 with TF32
off.  The checkpoint is the JAX CLI's flax tree, and the ``.log.jsonl``
lines carry the same keys.
"""

from __future__ import annotations

import argparse
import glob
import json
import time
from pathlib import Path

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--audio_glob", default="data/LibriSpeech/*.wav")
    ap.add_argument("--steps", type=int, default=20_000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=32_768 / 24_000)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--revive_every", type=int, default=250,
                    help="dead-codebook-code revival interval (0 = off)")
    ap.add_argument("--sisnr_weight", type=float, default=0.0,
                    help="negative-SI-SNR loss weight (phase-locking term)")
    ap.add_argument("--val_files", type=int, default=0,
                    help="hold out the last N files; eval si-snr/lsd/stoi every save_every")
    ap.add_argument("--size", choices=["full", "small"], default="full")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    from ..utils.config import CodecConfig
    from ..utils.flags import add_dataclass_args, dataclass_from_args

    add_dataclass_args(ap, CodecConfig, "cfg")  # --cfg.encoder_dim etc.
    args = ap.parse_args(argv)

    from ..codec.convert import flax_to_state_dict, state_dict_to_flax
    from ..train.codec_train import (init_codec_train, make_codec_eval_fn, make_codec_train_step,
                                     revive_dead_codes, speech_batches)
    from ..utils.checkpoint import load_params, save_params
    from ..utils.device import float32_parity, resolve_device

    dev = resolve_device(args.device)
    float32_parity()
    if args.size == "full":
        base = CodecConfig()
    else:
        base = CodecConfig(encoder_dim=8, latent_dim=64, decoder_dim=64,
                           codebook_size=128, codebook_dim=8)
    cfg = dataclass_from_args(CodecConfig, args, "cfg", base=base)

    files = sorted(glob.glob(args.audio_glob))
    if not files:
        raise SystemExit(f"no audio files match {args.audio_glob}")
    val_files: list[str] = []
    if args.val_files:
        val_files, files = files[-args.val_files:], files[: -args.val_files]
    print(f"[train_codec] {len(files)} train / {len(val_files)} val files, "
          f"cfg hop={cfg.hop} chunk={cfg.chunk}", flush=True)

    state = init_codec_train(args.seed, cfg, device=dev, lr=args.lr, total=args.steps)
    if args.resume:
        state.model.load_state_dict(flax_to_state_dict(load_params(args.resume), state.model))
        print(f"[train_codec] resumed params from {args.resume}", flush=True)
    step_fn = make_codec_train_step(cfg, sisnr_weight=args.sisnr_weight)

    t = int(args.seconds * cfg.sample_rate) // cfg.chunk * cfg.chunk or cfg.chunk
    batches = speech_batches(files, args.batch, t / cfg.sample_rate, cfg.sample_rate, seed=args.seed)

    eval_fn = None
    val_batch = None
    if val_files:
        eval_fn = make_codec_eval_fn(cfg)
        val_batch = torch.from_numpy(next(speech_batches(
            val_files, min(4 * args.batch, 64), t / cfg.sample_rate,
            cfg.sample_rate, seed=args.seed + 1, loop=False))[:, :t]).to(dev)

    out_path = Path(args.out)
    t_start = time.time()
    log_path = out_path.with_suffix(".log.jsonl")
    log_path.parent.mkdir(parents=True, exist_ok=True)
    usage = {i: np.zeros(cfg.codebook_size, np.int64) for i in range(cfg.num_levels)}
    revive_rng = np.random.default_rng(args.seed + 7)
    for step in range(1, args.steps + 1):
        wav = torch.from_numpy(next(batches)[:, :t]).to(dev)
        metrics = step_fn(state, wav)
        for i in range(cfg.num_levels):
            usage[i] += metrics[f"usage_{i}"].cpu().numpy().astype(np.int64)
        if step % args.log_every == 0:
            # before revival, which zeroes `usage`
            m = {k: float(v) for k, v in sorted(metrics.items()) if not k.startswith("usage_")}
            m["live_codes"] = [int((usage[i] > 0).sum()) for i in range(cfg.num_levels)]
            if eval_fn is not None and step % args.save_every == 0:
                m.update({k: float(v) for k, v in sorted(eval_fn(state.model, val_batch).items())})
            m.update(step=step, wall=round(time.time() - t_start, 1))
            print(f"[train_codec] {json.dumps(m)}", flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(m) + "\n")
        if args.revive_every and step % args.revive_every == 0:
            dead = revive_dead_codes(state.model, usage, cfg, revive_rng)
            usage = {i: np.zeros(cfg.codebook_size, np.int64) for i in range(cfg.num_levels)}
            print(f"[train_codec] revived dead codes per level: {dead} @ step {step}", flush=True)
        if step % args.save_every == 0 or step == args.steps:
            save_params(out_path, state_dict_to_flax(state.model))
            print(f"[train_codec] saved {out_path} @ step {step}", flush=True)


if __name__ == "__main__":
    main()
