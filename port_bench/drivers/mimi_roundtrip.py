"""The flagship path, ``entry(codec)``'s ``fn``, with Mimi as the codec:
spread-spectrum embed at 24 kHz -> codec round trip (gain, pad to a frame
of 1920 samples, the causal SEANet, the encoder transformer, the
downsampler, the split Euclidean RVQ at 8 codebooks, the upsampler, the
decoder transformer, the SEANet decoder) -> detect, on batches of
speech-like clips cycled from a pool made from the seed, back to back, one
caller.

Checked stage by stage on a sample of the window's calls, each stage fed
the program's previous output (forward hooks), clip by clip:

* ``marked_abs``: the largest |marked - reference embed|;
* ``latent_rel``: the reference SEANet encoder on the program's marked
  audio (its gain and frame padding) against the program's, and the
  reference downsampler on the program's transformer output against the
  program's latent: the larger largest per-clip relative rms;
* ``tfm_rel``: each reference transformer on the program transformer's
  input against the program's output, as the rms of the difference over
  the rms of what the reference transformer added to its input (the
  LayerScales of 0.01 keep that far below the input), the larger of the
  two;
* ``code_gap``: level by level from the program's latent, the reference
  following the program's codes: how far the chosen code's squared
  distance lies above the least one, over the least one (float64);
* ``decoded_rel``: the reference decoder on the program's codes;
* ``presence_abs`` and ``bit_z``: the reference's detect of the program's
  attacked audio.

The distinct codes of each level over the checked calls are printed on
standard error.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from port_bench import counts, counts_mimi, harness, inputs
from port_bench.drivers import roundtrip as base
from port_bench.reference import mimi as ref_mimi
from port_bench.reference import precision
from port_bench.reference import spread_spectrum as ref_ss
from port_bench.weights_mimi import make_codec

CHECKS = ("marked_abs", "latent_rel", "tfm_rel", "code_gap", "decoded_rel", "presence_abs", "bit_z")


class Capture:
    """Forward hooks that keep the last call's stages: the SEANet's output,
    each transformer's input and output, the latent, the codes, the
    decoded audio."""

    def __init__(self, model):
        self.last = {}

        def keep(name, inp=None):
            def hook(m, a, out):
                self.last[name] = out
                if inp:
                    self.last[inp] = a[0]
            return hook

        self.handles = [
            model.encoder.seanet.register_forward_hook(keep("seanet")),
            model.encoder.transformer.register_forward_hook(keep("enc_tfm")),
            model.encoder.register_forward_hook(keep("latent")),
            model.quantizer.register_forward_hook(lambda m, a, out: self.last.__setitem__("codes", out[1])),
            model.decoder.transformer.register_forward_hook(keep("dec_tfm", "dec_tfm_in")),
            model.decoder.register_forward_hook(keep("decoded")),
        ]

    def close(self):
        for h in self.handles:
            h.remove()


def work(cfg: dict, batch: int, samples: int) -> dict:
    """Counts of one call."""
    c = cfg["codec"]
    padded = -(-samples // ref_mimi.chunk(c)) * ref_mimi.chunk(c)
    enc, dec = counts_mimi.codec_layers(c, batch, padded)
    tfm_flops, tfm_bytes = counts_mimi.transformer_counts(c, batch, padded)
    wm = cfg["watermark"]
    peak = counts.PEAK_FLOPS[c["compute_dtype"]]
    return {"flops": counts_mimi.conv_flops(enc + dec) + tfm_flops + counts_mimi.rvq_flops(c, batch, padded)
            + counts.watermark_flops(wm, batch, samples, embed=True, detect=True),
            "peak_flops": peak,
            "tfm_bound_s": max(tfm_flops / peak, tfm_bytes / counts.PEAK_BYTES_PER_S),
            "sswm_bound_s": counts.sswm_bound_s(wm, batch, samples)}


def run(run) -> dict:
    from nawc_tpu_torch import entry as entry_mod
    from nawc_tpu_torch.models.spread_spectrum import SpreadSpectrumWM

    cfg, tr, dev = run.config, run.traffic, run.device
    harness.program_float32()
    codec, weights = make_codec(cfg["codec"], run.seed, dev)
    run.mark("weights")
    fn, _ = entry_mod.entry(codec, dev)
    base.program_wm_matches(entry_mod.flagship(codec, dev)[1], cfg["watermark"])
    n_samples = int(round(tr["seconds"] * tr["sample_rate"]))
    batch = tr["batch"]
    batches = base.pool(run, tr["pool_batches"], batch, n_samples, cfg["watermark"]["n_bits"])
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


def _framed(cfg: dict, marked: torch.Tensor) -> torch.Tensor:
    """The codec's input for `marked`: each clip at peak 0.7, padded to a frame."""
    g = 0.7 / torch.clamp(marked.abs().amax(dim=-1, keepdim=True), min=1e-4)
    return ref_mimi.pad_to(marked * g, ref_mimi.chunk(cfg["codec"]))


def control_answers(cfg, weights, batches, answers, control: str) -> list:
    """The reference in the control's precision, in the program's place, on
    the same calls, clip by clip."""
    prec = precision.get(control)
    precision.no_tf32()
    ref = ref_mimi.Mimi(weights, cfg["codec"], prec)
    out = []
    with torch.no_grad():
        for a in answers:
            wav, msg = batches[a["batch"]]
            marked = ref_ss.embed(cfg["watermark"], prec, wav, msg)
            clips = [ref_mimi.lalm_attack(ref, marked[i:i + 1]) for i in range(wav.shape[0])]
            presence, bits, _ = ref_ss.detect(cfg["watermark"], prec, torch.cat([c["attacked"] for c in clips]))

            def cat(key):
                return torch.cat([c[key] for c in clips])

            out.append({"batch": a["batch"], "marked": marked, "presence": presence, "bits": bits,
                        "seanet": cat("seanet"), "enc_tfm": cat("enc_tfm"), "latent": cat("latent"),
                        "codes": [torch.cat(level) for level in zip(*(c["codes"] for c in clips))],
                        "dec_tfm_in": cat("upsampled"), "dec_tfm": cat("dec_tfm"), "decoded": cat("decoded")})
    return out


def _shapes_fit(cfg: dict, wav: torch.Tensor, a: dict) -> bool:
    """Whether a call's answers have the shapes its batch asks for."""
    b, t = wav.shape
    c = cfg["codec"]
    padded = -(-t // ref_mimi.chunk(c)) * ref_mimi.chunk(c)
    tf = counts_mimi.frames(c, padded)
    d = c["latent_dim"]
    want = {"marked": (b, t), "presence": (b,), "bits": (b, cfg["watermark"]["n_bits"]),
            "seanet": (b, d, tf), "enc_tfm": (b, d, tf), "latent": (b, tf // c["resample_stride"], d),
            "dec_tfm_in": (b, d, tf), "dec_tfm": (b, d, tf), "decoded": (b, padded)}
    return (all(tuple(a[k].shape) == v for k, v in want.items())
            and [tuple(x.shape) for x in a["codes"]] == [(b, tf // c["resample_stride"])] * c["n_q"])


def _added_rel(got: torch.Tensor, want: torch.Tensor, before: torch.Tensor) -> float:
    """rms(got - want) / rms(want - before), per clip, the largest."""
    d = (got.double() - want.double()).flatten(1).pow(2).mean(-1).sqrt()
    n = (want.double() - before.double()).flatten(1).pow(2).mean(-1).sqrt()
    return float((d / n.clamp(min=1e-30)).max())


def judge(cfg: dict, weights: dict, batches, answers) -> dict:
    """The compared numbers, each the worst over the checked calls (see the
    module's docstring)."""
    prec_ = precision.get(cfg["precision"])
    precision.no_tf32()
    ref = ref_mimi.Mimi(weights, cfg["codec"], prec_)
    worst = {k: 0.0 for k in CHECKS}
    if not answers:
        return {k: math.inf for k in worst}
    distinct = [set() for _ in range(cfg["codec"]["n_q"])]
    t0 = time.perf_counter()
    with torch.no_grad():
        for a in answers:
            wav, msg = batches[a["batch"]]
            if not _shapes_fit(cfg, wav, a):
                worst = {k: math.inf for k in worst}
                break
            try:
                marked = ref_ss.embed(cfg["watermark"], prec_, wav, msg)
                x = _framed(cfg, a["marked"])
                got = {"marked_abs": float((a["marked"] - marked).abs().max()), "latent_rel": 0.0,
                       "tfm_rel": 0.0, "code_gap": 0.0, "decoded_rel": 0.0}
                for i in range(wav.shape[0]):
                    one = slice(i, i + 1)
                    seanet = ref.seanet_encoder(prec_.store(x[one])[:, None, :])
                    latent = ref.downsample(a["enc_tfm"][one].float())
                    got["latent_rel"] = max(got["latent_rel"], base._rel_rms(a["seanet"][one].flatten(1),
                                                                             seanet.flatten(1)),
                                            base._rel_rms(a["latent"][one].flatten(1), latent.flatten(1)))
                    for name, inp, out in (("encoder", "seanet", "enc_tfm"), ("decoder", "dec_tfm_in", "dec_tfm")):
                        before = a[inp][one].float()
                        want = ref.transformer(f"{name}.transformer", before)
                        got["tfm_rel"] = max(got["tfm_rel"], _added_rel(a[out][one], want, before))
                    codes = [c[one] for c in a["codes"]]
                    zq, _, gaps = ref.quantize(a["latent"][one].float(), forced=codes)
                    got["code_gap"] = max([got["code_gap"]] + [float(g.max()) for g in gaps])
                    decoded = ref.decode_latent(zq)["decoded"]
                    got["decoded_rel"] = max(got["decoded_rel"], base._rel_rms(a["decoded"][one], decoded))
                    for level, c in zip(distinct, codes):
                        level.update(c.flatten().tolist())
                # the detect stage on the program's attacked audio: its decoded audio
                # scaled back by the gain of its marked audio, cut to the clip
                g = 0.7 / torch.clamp(a["marked"].abs().amax(dim=-1, keepdim=True), min=1e-4)
                attacked = (a["decoded"] / g)[:, : wav.shape[-1]]
                presence, bits, z = ref_ss.detect(cfg["watermark"], prec_, attacked)
                got["presence_abs"] = float((a["presence"] - presence).abs().max())
                got["bit_z"] = float(torch.where(a["bits"] != bits, z.abs(), torch.zeros_like(z)).max())
            except (RuntimeError, IndexError, ValueError):
                got = {k: math.inf for k in worst}  # shapes or codes the reference cannot read
            for k, v in got.items():
                worst[k] = max(worst[k], v if not np.isnan(v) else math.inf)
    print(f"port_bench: reference {time.perf_counter() - t0:.2f} s for {len(answers)} calls; distinct codes "
          f"per level {[len(s) for s in distinct]}", file=sys.stderr)
    return worst
