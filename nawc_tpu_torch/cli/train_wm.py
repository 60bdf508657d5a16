"""Train the neural additive watermarker (generator + detector jointly).

Usage:
  python -m nawc_tpu_torch.cli.train_wm --steps 10000 --batch 16 \
      --out checkpoints/neural_wm.msgpack

The flags and defaults of ``nawc_tpu.cli.train_wm``, plus ``--device``
(default cuda); float32 with TF32 off.  The checkpoint is the JAX CLI's
``{"gen", "det"}`` flax tree, and the ``.log.jsonl`` lines carry the same
keys.
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
    ap.add_argument("--steps", type=int, default=10_000)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="checkpoints/neural_wm.msgpack")
    ap.add_argument("--resume", default=None)
    ap.add_argument("--start_step", type=int, default=0,
                    help="curriculum offset added to the step counter; use on --resume so the "
                         "attack-severity ramp does not restart from zero")
    ap.add_argument("--log_every", type=int, default=50)
    ap.add_argument("--save_every", type=int, default=500)
    ap.add_argument("--codec_ckpt", default=None,
                    help="enable the differentiable codec-roundtrip attack branch (every 3rd "
                         "step) against this codec")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..models.base import random_message
    from ..models.neural import neural_from_flax, neural_to_flax
    from ..train.codec_train import speech_batches
    from ..train.wm_train import init_wm_train, make_wm_train_step
    from ..utils import jaxrand
    from ..utils.checkpoint import load_params, save_params
    from ..utils.config import NeuralWMConfig
    from ..utils.device import float32_parity, resolve_device
    from .common import load_codec

    dev = resolve_device(args.device)
    float32_parity()
    cfg = NeuralWMConfig()
    files = sorted(glob.glob(args.audio_glob))
    t = int(args.seconds * cfg.sample_rate)
    state = init_wm_train(args.seed, cfg, lr=args.lr, weight_decay=1e-5, device=dev)
    if args.resume:
        blob = load_params(args.resume)
        loaded = neural_from_flax(blob["gen"], blob["det"], cfg, device=dev)
        state.wm.gen.load_state_dict(loaded.gen.state_dict())
        state.wm.det.load_state_dict(loaded.det.state_dict())
        print(f"[train_wm] resumed from {args.resume}", flush=True)
    step_fn = make_wm_train_step(cfg)
    step_fn_codec = None
    if args.codec_ckpt:
        step_fn_codec = make_wm_train_step(cfg, codec=load_codec(args.codec_ckpt, device=dev))
    batches = speech_batches(files, args.batch, args.seconds, cfg.sample_rate, seed=args.seed)

    key = jaxrand.prng_key(args.seed + 1)
    out_path = Path(args.out)
    log_path = out_path.with_suffix(".log.jsonl")
    log_path.parent.mkdir(parents=True, exist_ok=True)
    t_start = time.time()
    for step in range(1, args.steps + 1):
        wav = torch.from_numpy(next(batches)[:, :t]).to(dev)
        key, km, kk = jaxrand.split(key, 3)
        msg = random_message(km, args.batch, cfg.n_bits, device=dev)
        fn = step_fn_codec if (step_fn_codec is not None and step % 3 == 0) else step_fn
        metrics = fn(state, wav, msg, kk, step + args.start_step)
        if step % args.log_every == 0:
            m = {k: float(v) for k, v in sorted(metrics.items())}
            m.update(step=step, wall=round(time.time() - t_start, 1))
            print(f"[train_wm] {json.dumps(m)}", flush=True)
            with open(log_path, "a") as f:
                f.write(json.dumps(m) + "\n")
        if step % args.save_every == 0 or step == args.steps:
            save_params(out_path, neural_to_flax(state.wm))
            print(f"[train_wm] saved {out_path} @ {step}", flush=True)


if __name__ == "__main__":
    main()
