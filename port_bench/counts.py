"""Operations and bytes that the work needs, from shapes, and the card's
peaks.

Counts are of the work the inputs need, whatever a kernel reads again or
recomputes: each input byte read once and each output byte written once.
A later kernel that does the same work another way reads against the same
yardstick.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 67 TFLOP/s float32 outside the tensor cores, 495 TFLOP/s TF32 and
989 TFLOP/s bfloat16 on them, 3.35 TB/s of HBM3.  A share of a peak is
read against these, with the card's name and power limit beside it.
"""

from __future__ import annotations

import math

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "tf32": 495e12, "bfloat16": 989e12}
DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _len(t: int, s: int) -> int:
    return -(-t // s)


def codec_layers(cfg: dict, batch: int, samples: int):
    """The codec's convolutions and Snakes at a (batch, samples) input, as
    ("conv", c_in, c_out, k, t_out, macs_per_output) and ("snake", channels,
    t) entries, encoder first.  A transposed conv's MACs per output sample
    are c_in k / stride."""
    enc, dec = [], []
    t, d = samples, cfg["encoder_dim"]
    enc.append(("conv", 1, d, 7, t))
    for rate in cfg["encoder_rates"]:
        for _ in range(3):
            enc += [("snake", d, t), ("conv", d, d, 7, t), ("snake", d, t), ("conv", d, d, 1, t)]
        t = _len(t, rate)
        enc += [("snake", d, t * rate), ("conv", d, 2 * d, 2 * rate, t)]
        d *= 2
    enc += [("snake", d, t), ("conv", d, cfg["latent_dim"], 3, t)]
    d = cfg["decoder_dim"]
    dec.append(("conv", cfg["latent_dim"], d, 7, t))
    for rate in cfg["decoder_rates"]:
        dec += [("snake", d, t), ("tconv", d, d // 2, 2 * rate, t * rate, rate)]
        t, d = t * rate, d // 2
        for _ in range(3):
            dec += [("snake", d, t), ("conv", d, d, 7, t), ("snake", d, t), ("conv", d, d, 1, t)]
    dec += [("snake", d, t), ("conv", d, 1, 7, t)]
    return [(batch,) + e for e in enc], [(batch,) + e for e in dec]


def conv_flops(layers) -> float:
    """2 x MACs of the convolutions among `layers`."""
    total = 0.0
    for e in layers:
        if e[1] == "conv":
            b, _, cin, cout, k, t = e
            total += 2.0 * b * t * cout * cin * k
        elif e[1] == "tconv":
            b, _, cin, cout, k, t, s = e
            total += 2.0 * b * t * cout * cin * k / s
    return total


def snake_bytes(layers, dtype: str, backward: bool = False, dalpha: bool = False) -> float:
    """Bytes the Snakes among `layers` need: forward x and alpha read and y
    written; backward x and dy read and dx written, and where d alpha is
    wanted its (C,) sums written."""
    n = DTYPE_BYTES[dtype]
    total = 0.0
    for e in layers:
        if e[1] == "snake":
            b, _, c, t = e
            total += 2.0 * n * b * c * t + 4.0 * c
            if backward:
                total += 3.0 * n * b * c * t + 4.0 * c + (4.0 * c if dalpha else 0.0)
    return total


def frames(samples: int, n_fft: int = 1024, hop: int = 256) -> int:
    return 1 + _len(samples, hop)


def band_width(wm: dict) -> int:
    top = wm["n_fft"] // 2
    lo = int(round(wm["band_lo_hz"] / (wm["sample_rate"] / 2) * top))
    hi = int(round(wm["band_hi_hz"] / (wm["sample_rate"] / 2) * top))
    return max(hi, lo + 8) - lo


def sswm_counts(wm: dict, batch: int, samples: int) -> tuple[float, float, float]:
    """-> (bytes, float32 flops, TF32 flops) that whiten-correlate needs:
    the residual, the patterns and z once each; a sum and a sum of squares
    per residual cell; one multiply-add per (pattern variant, clip, bit,
    frame, bin), which the kernel runs as three TF32 passes."""
    t, w, k = frames(samples, wm["n_fft"], wm["hop"]), band_width(wm), wm["n_bits"]
    nv = 1 + len(wm["null_offsets"])
    return (4.0 * (batch * t * w + k * t * w + batch * k), 3.0 * batch * t * w,
            3 * 2.0 * nv * batch * k * t * w)


def sswm_bound_s(wm: dict, batch: int, samples: int) -> float:
    nbytes, flops, tf32 = sswm_counts(wm, batch, samples)
    return max(nbytes / PEAK_BYTES_PER_S, flops / PEAK_FLOPS["float32"] + tf32 / PEAK_FLOPS["tf32"])


def watermark_flops(wm: dict, batch: int, samples: int, embed: bool, detect: bool) -> float:
    """The spread-spectrum watermark's arithmetic: 2.5 N log2 N a real FFT
    of N points (four a frame in an embed of two passes, one in a detect),
    the embed's pattern sum and the detect's correlations."""
    t, w, k = frames(samples, wm["n_fft"], wm["hop"]), band_width(wm), wm["n_bits"]
    fft = 2.5 * wm["n_fft"] * math.log2(wm["n_fft"]) * batch * t
    total = 0.0
    if embed:
        total += 2 * wm["n_passes"] * fft + 2.0 * batch * k * t * w
    if detect:
        total += fft + 2.0 * (1 + len(wm["null_offsets"])) * batch * k * t * w
    return total
