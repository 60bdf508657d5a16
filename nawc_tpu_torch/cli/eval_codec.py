"""Evaluate a trained codec checkpoint: reconstruction quality (mel distance,
SI-SNR, LSD, STOI) and codebook utilization on held-out clips.

Usage:
  python -m nawc_tpu_torch.cli.eval_codec --ckpt checkpoints/codec_24k.msgpack --filecount 8

The flags and defaults of ``nawc_tpu.cli.eval_codec``, plus ``--device``
(default cuda); float32 with TF32 off.
"""

from __future__ import annotations

import argparse

import torch


def main(argv=None) -> None:
    from .common import DEFAULT_AUDIO_GLOB, load_audio_batch, load_codec

    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--ckpt", default="checkpoints/codec_24k.msgpack")
    ap.add_argument("--size", choices=["full", "small"], default="full")
    ap.add_argument("--audio_glob", default=DEFAULT_AUDIO_GLOB)
    ap.add_argument("--filecount", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--offset", type=int, default=100, help="skip training files")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..dsp.mel import mel_spectrogram
    from ..eval.metrics import lsd, si_snr, stoi
    from ..utils.config import MelConfig, StftConfig
    from ..utils.device import float32_parity, resolve_device

    dev = resolve_device(args.device)
    float32_parity()
    codec = load_codec(args.ckpt, args.size, device=dev)
    sr = codec.cfg.sample_rate
    t = int(args.seconds * sr) // codec.cfg.chunk * codec.cfg.chunk
    wav = load_audio_batch(args.audio_glob, args.filecount, sr, t / sr, offset=args.offset).to(dev)
    # operate at the codec's training loudness (speech_batches peak=0.7)
    peak = torch.amax(torch.abs(wav), dim=-1, keepdim=True)
    wav = wav * (0.7 / torch.clamp(peak, min=1e-4))

    with torch.no_grad():
        codes = codec.encode(wav)
        recon = codec.decode(codes)
        scfg = StftConfig(1024, 256, 1024)
        mcfg = MelConfig(sample_rate=sr, n_fft=1024, n_mels=80)
        mel_l1 = float(torch.mean(torch.abs(mel_spectrogram(wav, scfg, mcfg)
                                            - mel_spectrogram(recon, scfg, mcfg))))
        usage = [round(len(torch.unique(c)) / codec.cfg.codebook_size, 4) for c in codes]
        print({
            "mel_l1": round(mel_l1, 4),
            "si_snr_db": round(float(torch.mean(si_snr(wav, recon))), 2),
            "lsd": round(float(torch.mean(lsd(wav, recon))), 2),
            "stoi": round(float(torch.mean(stoi(wav, recon, sr))), 3),
            "codebook_usage_per_level": usage,
            "recon_rms": round(float(torch.sqrt(torch.mean(recon**2))), 4),
            "wav_rms": round(float(torch.sqrt(torch.mean(wav**2))), 4),
        })


if __name__ == "__main__":
    main()
