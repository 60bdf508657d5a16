"""File-level watermarking tool (``nawc_tpu/cli/watermark.py``): embed or
detect on one WAV file.

Usage (add --device cpu to run on the CPU):
  python -m nawc_tpu_torch.cli.watermark embed --input x.wav --output y.wav \\
      --method spread_spectrum --message 0xBEEF
  python -m nawc_tpu_torch.cli.watermark detect --input y.wav --method spread_spectrum [--sync]

Each prints one JSON line.  Without ``--message`` a multi-bit method embeds
``jax.random.bernoulli(PRNGKey(0), 0.5, (1, n_bits))``, as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def _msg_bits(message: str, n_bits: int) -> np.ndarray:
    """Hex (0x...) or binary string -> (1, n_bits) bit array."""
    if message.startswith(("0x", "0X")):
        val = int(message, 16)
        bits = [(val >> (n_bits - 1 - i)) & 1 for i in range(n_bits)]
    else:
        if len(message) != n_bits or set(message) - {"0", "1"}:
            raise SystemExit(f"--message must be 0x hex or {n_bits} binary digits")
        bits = [int(c) for c in message]
    return np.asarray([bits], np.int32)


def _bits_msg(bits: np.ndarray) -> str:
    val = 0
    for b in bits:
        val = (val << 1) | int(b)
    return hex(val)


def main(argv=None) -> None:
    from .common import WM_CHOICES, build_watermarkers, load_codec

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("command", choices=["embed", "detect"])
    ap.add_argument("--input", required=True)
    ap.add_argument("--output", default=None)
    ap.add_argument("--method", default="spread_spectrum", choices=WM_CHOICES)
    ap.add_argument("--message", default=None, help="payload: 0xHEX or bit string")
    ap.add_argument("--sync", action="store_true", help="shift-robust detection")
    ap.add_argument("--codec_ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--codec_size", choices=["full", "small"], default="full")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..dsp.resample import resample
    from ..utils import audio_io, jaxrand
    from ..utils.device import float32_parity, resolve_device
    from ..utils.padding import pad_to_multiple

    dev = resolve_device(args.device)
    float32_parity()
    needs_codec = args.method.startswith("semantic") or args.method == "token_green"
    codec = load_codec(args.codec_ckpt, args.codec_size, device=dev) if needs_codec else None
    wm = build_watermarkers([args.method], codec, device=dev)[args.method]

    audio, sr = audio_io.read_wav(args.input)
    x = torch.as_tensor(audio.mean(axis=0), device=dev)
    if sr != wm.sample_rate:
        x = resample(x, sr, wm.sample_rate)
    t = x.shape[-1]
    x = pad_to_multiple(x[None], 4096)

    with torch.no_grad():
        if args.command == "embed":
            if wm.n_bits:
                bits = (_msg_bits(args.message, wm.n_bits) if args.message else
                        jaxrand.bernoulli(jaxrand.prng_key(0), 0.5, (1, wm.n_bits)).astype(np.int32))
                msg = torch.as_tensor(bits, device=dev)
                marked = wm.embed(x, msg, jaxrand.prng_key(0))
                payload = _bits_msg(bits[0])
            else:
                marked = wm.embed(x)
                payload = "(presence-only)"
            y = marked[0, :t]
            if sr != wm.sample_rate:
                y = resample(y, wm.sample_rate, sr)
            out = args.output or args.input.replace(".wav", ".marked.wav")
            audio_io.write_wav(out, y.cpu().numpy(), sr)
            print(json.dumps({"written": out, "payload": payload,
                              "method": args.method, "sample_rate": sr}))
        else:
            if args.sync and hasattr(wm, "detect_sync"):
                presence, bits, lag = wm.detect_sync(x)
                extra = {"lag_frames": int(lag[0])}
            else:
                presence, bits = wm.detect(x)
                extra = {}
            p = float(presence[0])
            result = {"method": args.method, "presence": round(p, 4), "detected": bool(p > 0.5),
                      **extra}
            if wm.n_bits:
                result["payload"] = _bits_msg(bits[0].cpu().numpy())
            print(json.dumps(result))


if __name__ == "__main__":
    main()
