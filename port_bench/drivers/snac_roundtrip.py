"""The flagship path, ``entry(codec)``'s ``fn``, with SNAC 44 kHz as the
codec: spread-spectrum embed at 44.1 kHz -> codec round trip (gain, pad to
SNAC's chunk, encode with windowed attention, a four-level RVQ, decode with
noise blocks) -> detect, on batches of speech-like clips cycled from a pool
made from the seed, back to back, one caller.

Checked as ``roundtrip.py`` checks the 24 kHz codec, stage by stage on a
sample of the window's calls, each stage fed the program's previous output,
plus the noise: the normals each noise block drew (read with its key by a
forward hook on the block's draw) against the reference's draw from that
key (``noise_abs``, float32); the reference decodes with the program's
noise.
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np
import torch

from port_bench import counts, counts_snac, harness, inputs
from port_bench.drivers import roundtrip as base
from port_bench.reference import precision
from port_bench.reference import snac as ref_snac
from port_bench.reference import spread_spectrum as ref_ss
from port_bench.weights_snac import make_codec

CHECKS = ("marked_abs", "latent_rel", "code_gap", "noise_abs", "decoded_rel", "presence_abs",
          "bit_z")


class Capture(base.Capture):
    """``roundtrip.Capture``, and the last call's noise: (key, normals) of
    each noise block's draw, in order."""

    def __init__(self, model):
        super().__init__(model)
        draws = [m for n, m in model.named_modules() if n.endswith("NoiseBlock_0.draw")]
        self.handles += [model.decoder.register_forward_pre_hook(
            lambda m, a: self.last.__setitem__("noise", []))]
        self.handles += [d.register_forward_hook(
            lambda m, a, out: self.last["noise"].append((np.array(a[0]), out))) for d in draws]


def work(cfg: dict, batch: int, samples: int) -> dict:
    """Counts of one call."""
    c = cfg["codec"]
    padded = -(-samples // ref_snac.chunk(c)) * ref_snac.chunk(c)
    enc, dec = counts_snac.codec_layers(c, batch, padded)
    wm = cfg["watermark"]
    dtype = c["compute_dtype"]
    return {"flops": counts_snac.conv_flops(enc + dec) + counts_snac.attention_flops(enc + dec)
            + counts.watermark_flops(wm, batch, samples, embed=True, detect=True),
            "peak_flops": counts.PEAK_FLOPS[dtype],
            "snake_bytes": counts.snake_bytes(enc + dec, dtype),
            "dwconv_bytes": counts_snac.dwconv_bytes(enc + dec, dtype),
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


def control_answers(cfg, weights, batches, answers, control: str) -> list:
    """The reference in the control's precision, in the program's place, on
    the same calls, drawing its noise from the program's keys."""
    prec = precision.get(control)
    precision.no_tf32()
    ref = ref_snac.Snac(weights, cfg["codec"], prec)
    out = []
    with torch.no_grad():
        for a in answers:
            wav, msg = batches[a["batch"]]
            noise = [(key, prec.store(ref_snac.normal(key, n.shape, n.device)))
                     for key, n in a["noise"]]
            marked = ref_ss.embed(cfg["watermark"], prec, wav, msg)
            att = ref_snac.lalm_attack(ref, marked, [n for _, n in noise])
            presence, bits, _ = ref_ss.detect(cfg["watermark"], prec, att["attacked"])
            out.append({"batch": a["batch"], "marked": marked, "presence": presence,
                        "bits": bits, "codes": att["codes"], "decoded": att["decoded"],
                        "latent": att["latent"], "noise": noise})
    return out


def _shapes_fit(cfg: dict, wav: torch.Tensor, a: dict) -> bool:
    """Whether a call's answers have the shapes its batch asks for, one
    noise draw a decoder block among them."""
    b, t = wav.shape
    c = cfg["codec"]
    padded = -(-t // ref_snac.chunk(c)) * ref_snac.chunk(c)
    frames = padded // math.prod(c["encoder_rates"])
    want = [(b, t), (b,), (b, cfg["watermark"]["n_bits"]), (b, padded),
            (b, frames, c["latent_dim"])]
    got = [tuple(a[k].shape) for k in ("marked", "presence", "bits", "decoded", "latent")]
    codes = [tuple(x.shape) for x in a["codes"]]
    rates = np.cumprod(c["decoder_rates"])
    noise = [tuple(n.shape) for _, n in a.get("noise", [])]
    return (got == want and codes == [(b, frames // s) for s in c["vq_strides"]]
            and noise == [(b, 1, frames * int(r)) for r in rates])


def judge(cfg: dict, weights: dict, batches, answers) -> dict:
    """The compared numbers, each the worst over the checked calls:
    ``roundtrip.judge``'s, and noise_abs, the largest |program's normal -
    reference's normal from the same key|."""
    prec_ = precision.get(cfg["precision"])
    precision.no_tf32()
    ref = ref_snac.Snac(weights, cfg["codec"], prec_)
    worst = {k: 0.0 for k in CHECKS}
    if not answers:
        return {k: math.inf for k in worst}
    t0 = time.perf_counter()
    with torch.no_grad():
        for a in answers:
            wav, msg = batches[a["batch"]]
            if not _shapes_fit(cfg, wav, a):
                worst = {k: math.inf for k in worst}
                break
            try:
                noise_abs = max(float((n - ref_snac.normal(key, n.shape, n.device)).abs().max())
                                for key, n in a["noise"])
                marked = ref_ss.embed(cfg["watermark"], prec_, wav, msg)
                att = ref_snac.lalm_attack(ref, marked, [n for _, n in a["noise"]],
                                           forced=a["codes"])
                _, _, gaps = ref.quantize(a["latent"], forced=a["codes"])
                # the detect stage on the program's attacked audio: its decoded audio
                # scaled back by the gain of its marked audio, cut to the clip
                g = 0.7 / torch.clamp(a["marked"].abs().amax(dim=-1, keepdim=True), min=1e-4)
                attacked = (a["decoded"] / g)[:, : wav.shape[-1]]
                presence, bits, z = ref_ss.detect(cfg["watermark"], prec_, attacked)
                got = {"marked_abs": float((a["marked"] - marked).abs().max()),
                       "latent_rel": base._rel_rms(a["latent"].flatten(1), att["latent"].flatten(1)),
                       "code_gap": max(float(g.max()) for g in gaps),
                       "noise_abs": noise_abs,
                       "decoded_rel": base._rel_rms(a["decoded"], att["decoded"]),
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
