"""The flagship path, ``entry(codec)``'s ``fn``: spread-spectrum embed ->
codec round trip (the LALM attack: gain, pad, encode, quantize, decode)
-> detect, on batches of speech-like clips cycled from a pool made from the
seed, back to back, one caller.

Checked: a sample of the window's calls, drawn from the seed, against the
reference, stage by stage: the marked audio; the encoder's latent; the
codes the quantizer chose from the program's latent (each code's cosine
below the best one's, the reference following the program's codes from
level to level); the decoded audio (the reference decoding the program's
codes); presence and bits of the reference's detect of the program's
attacked audio.  The latent, the codes and the decoded audio are read from
the timed calls by forward hooks on the codec's encoder, quantizer and
decoder.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from port_bench import counts, harness, inputs
from port_bench.reference import codec as ref_codec
from port_bench.reference import precision
from port_bench.reference import spread_spectrum as ref_ss
from port_bench.weights import make_codec

WM_FIELDS = ("sample_rate", "n_bits", "n_fft", "hop", "band_lo_hz", "band_hi_hz", "alpha",
             "mask_quantile", "mask_lo_quantile")


def program_wm_matches(wm, block: dict) -> None:
    """The configuration file states the watermarker the program builds."""
    got = {f: getattr(wm.cfg, f) for f in WM_FIELDS}
    got.update(seed=wm.seed, n_passes=wm.n_passes, presence_z0=wm.presence_z0,
               presence_gain=wm.presence_gain)
    want = {k: block[k] for k in got}
    if got != want:
        raise ValueError(f"the configuration's watermark {want} is not the program's {got}")


def pool(run, n_batches: int, batch: int, n_samples: int, n_bits: int) -> list:
    r = inputs.rng(run.seed, "roundtrip")
    out = []
    for _ in range(n_batches):
        wav = torch.from_numpy(inputs.speech_clips(r, batch, n_samples, run.traffic["sample_rate"]))
        msg = torch.from_numpy(inputs.messages(r, batch, n_bits))
        out.append((wav.to(run.device), msg.to(run.device)))
    return out


class Capture:
    """Forward hooks that keep the last call's latent, codes and decoded
    audio."""

    def __init__(self, model):
        self.last = {}
        self.handles = [
            model.encoder.register_forward_hook(
                lambda m, a, out: self.last.__setitem__("latent", out)),
            model.quantizer.register_forward_hook(
                lambda m, a, out: self.last.__setitem__("codes", out[1])),
            model.decoder.register_forward_hook(
                lambda m, a, out: self.last.__setitem__("decoded", out)),
        ]

    def close(self):
        for h in self.handles:
            h.remove()


def work(cfg: dict, batch: int, samples: int) -> dict:
    """Counts of one call."""
    padded = -(-samples // ref_codec.chunk(cfg["codec"])) * ref_codec.chunk(cfg["codec"])
    enc, dec = counts.codec_layers(cfg["codec"], batch, padded)
    wm = cfg["watermark"]
    dtype = cfg["codec"]["compute_dtype"]
    return {"flops": counts.conv_flops(enc + dec)
            + counts.watermark_flops(wm, batch, samples, embed=True, detect=True),
            "peak_flops": counts.PEAK_FLOPS[dtype],
            "snake_bytes": counts.snake_bytes(enc + dec, dtype),
            "sswm_bound_s": counts.sswm_bound_s(wm, batch, samples)}


def run(run) -> dict:
    from nawc_tpu_torch import entry as entry_mod
    from nawc_tpu_torch.models.spread_spectrum import SpreadSpectrumWM

    cfg, tr, dev = run.config, run.traffic, run.device
    harness.program_float32()
    codec, weights = make_codec(cfg["codec"], run.seed, dev)
    run.mark("weights")
    fn, _ = entry_mod.entry(codec, dev)
    program_wm_matches(entry_mod.flagship(codec, dev)[1], cfg["watermark"])
    n_samples = int(round(tr["seconds"] * tr["sample_rate"]))
    batch = tr["batch"]
    batches = pool(run, tr["pool_batches"], batch, n_samples, cfg["watermark"]["n_bits"])
    run.mark("inputs")
    cap = Capture(codec.model)
    for i in range(tr["warm_calls"]):
        fn(*batches[i % len(batches)])
    harness.sync(dev)
    run.setup_done()

    sample = harness.Reservoir(tr["checked_calls"], inputs.rng(run.seed, "checked calls"))

    def keep(i, out):
        sample.offer(lambda: {"batch": i % len(batches), "marked": out[0], "presence": out[1],
                              "bits": out[2], **cap.last})

    call = lambda i: fn(*batches[i % len(batches)])  # noqa: E731
    spans = harness.Spans(dev)
    record = {}
    if run.trace:
        with spans.around(SpreadSpectrumWM, "embed", "wm.embed"), \
                spans.around(SpreadSpectrumWM, "detect", "wm.detect"), \
                spans.around(entry_mod, "codec_roundtrip", "codec.roundtrip"):
            win = harness.closed_loop(call, run.seconds, dev, keep)
        with spans.around(SpreadSpectrumWM, "embed", "wm.embed", synced=False), \
                spans.around(SpreadSpectrumWM, "detect", "wm.detect", synced=False), \
                spans.around(entry_mod, "codec_roundtrip", "codec.roundtrip", synced=False):
            prof = harness.profile_window(call, tr["profile_calls"], dev)
        prof["unit"] = "call"
        record = {"calls": len(win["call_s"]), "call_s": win["call_s"], "spans": spans.seconds,
                  "profile": prof, "work": work(cfg, batch, n_samples)}
    else:
        win = harness.closed_loop(call, run.seconds, dev, keep)
    run.read_peak()
    cap.close()
    del fn, codec, cap
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    answers = sample.items
    if run.mode == "control":
        answers = control_answers(cfg, weights, batches, answers, run.control)
    checks = judge(cfg, weights, batches, answers)
    wall = win["end"] - win["start"]
    n = len(win["call_s"])
    return {"e2e": {"audio_s_per_s": n * batch * tr["seconds"] / wall,
                    "call_p95_ms": harness.p95(win["call_s"]) * 1e3},
            "attempted": n, "failed": 0, "record": record, "checks": checks}


def control_answers(cfg, weights, batches, answers, control: str) -> list:
    """The reference in the control's precision, in the program's place,
    on the same calls."""
    prec = precision.get(control)
    precision.no_tf32()
    ref = ref_codec.Codec(weights, cfg["codec"], prec)
    out = []
    with torch.no_grad():
        for a in answers:
            wav, msg = batches[a["batch"]]
            marked = ref_ss.embed(cfg["watermark"], prec, wav, msg)
            att = ref_codec.lalm_attack(ref, marked)
            presence, bits, _ = ref_ss.detect(cfg["watermark"], prec, att["attacked"])
            out.append({"batch": a["batch"], "marked": marked, "presence": presence,
                        "bits": bits, "codes": att["codes"], "decoded": att["decoded"],
                        "latent": att["latent"]})
    return out


def _rel_rms(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest per-clip rms of a - b over the rms of b."""
    d = (a.double() - b.double()).pow(2).mean(dim=-1).sqrt()
    return float((d / b.double().pow(2).mean(dim=-1).sqrt().clamp(min=1e-30)).max())


def _shapes_fit(cfg: dict, wav: torch.Tensor, a: dict) -> bool:
    """Whether a call's answers have the shapes its batch asks for (a
    smaller answer would broadcast against the reference's)."""
    b, t = wav.shape
    c = cfg["codec"]
    padded = -(-t // ref_codec.chunk(c)) * ref_codec.chunk(c)
    frames = padded // math.prod(c["encoder_rates"])
    want = [(b, t), (b,), (b, cfg["watermark"]["n_bits"]), (b, padded),
            (b, frames, c["latent_dim"])]
    got = [tuple(a[k].shape) for k in ("marked", "presence", "bits", "decoded", "latent")]
    codes = [tuple(x.shape) for x in a["codes"]]
    return got == want and codes == [(b, frames // s) for s in c["vq_strides"]]


def judge(cfg: dict, weights: dict, batches, answers) -> dict:
    """The compared numbers, each the worst over the checked calls:
    marked_abs; latent_rel (the encoder's output against the reference's,
    largest per-clip relative rms); code_gap (from the program's latent);
    decoded_rel; presence_abs; bit_z (the largest |z| of the reference
    among the bits where the program disagrees)."""
    prec_ = precision.get(cfg["precision"])
    precision.no_tf32()
    ref = ref_codec.Codec(weights, cfg["codec"], prec_)
    worst = {"marked_abs": 0.0, "latent_rel": 0.0, "code_gap": 0.0, "decoded_rel": 0.0,
             "presence_abs": 0.0, "bit_z": 0.0}
    if not answers:
        return {k: math.inf for k in worst}
    t0 = time.perf_counter()
    with torch.no_grad():
        for a in answers:
            wav, msg = batches[a["batch"]]
            if not _shapes_fit(cfg, wav, a):
                worst = {k: math.inf for k in worst}
                break
            marked = ref_ss.embed(cfg["watermark"], prec_, wav, msg)
            try:
                att = ref_codec.lalm_attack(ref, marked, forced=a["codes"])
                _, _, gaps = ref.quantize(a["latent"], forced=a["codes"])
                # the detect stage on the program's attacked audio: its decoded audio
                # scaled back by the gain of its marked audio, cut to the clip
                g = 0.7 / torch.clamp(a["marked"].abs().amax(dim=-1, keepdim=True), min=1e-4)
                attacked = (a["decoded"] / g)[:, : wav.shape[-1]]
                presence, bits, z = ref_ss.detect(cfg["watermark"], prec_, attacked)
                decoded = att["decoded"]
                got = {"marked_abs": float((a["marked"] - marked).abs().max()),
                       "latent_rel": _rel_rms(a["latent"].flatten(1), att["latent"].flatten(1)),
                       "code_gap": max(float(g.max()) for g in gaps),
                       "decoded_rel": _rel_rms(a["decoded"], decoded),
                       "presence_abs": float((a["presence"] - presence).abs().max()),
                       "bit_z": float(torch.where(a["bits"] != bits, z.abs(),
                                                  torch.zeros_like(z)).max())}
            except (RuntimeError, IndexError, ValueError):
                got = {k: math.inf for k in worst}  # shapes or codes the reference cannot read
            for k, v in got.items():
                worst[k] = max(worst[k], v if not np.isnan(v) else math.inf)
    print(f"port_bench: reference {time.perf_counter() - t0:.2f} s for {len(answers)} calls",
          file=sys.stderr)
    return worst
