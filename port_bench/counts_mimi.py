"""Operations and bytes that the Mimi codec's work needs, from shapes, with
the yardstick of ``counts.py``: each input byte read once and each output
byte written once, whatever a kernel reads again or recomputes.

:func:`codec_layers` lists the codec's conv layers at a (batch, samples)
input, encoder first, as tuples (batch, kind, ...):

* ("conv", c_in, c_out, k, t_out): a conv (the SEANet's, strided ones too,
  and the downsampler);
* ("tconv", c_in, c_out, k, t_out, stride, groups): a transposed conv (the
  SEANet decoder's and the upsampler).

:func:`transformer_counts` gives the two transformers' FLOPs and bytes: the
projections, the MLP and the windowed q k^T and p v (2 d_head FLOPs a
query-key pair of the window and head, each way); weights read once; each
of those ops' inputs read and outputs written once, in the compute type.
"""

from __future__ import annotations

import math

from port_bench.counts import DTYPE_BYTES


def window_pairs(t: int, context: int) -> int:
    """Query-key pairs 0 <= t_q - t_k < `context` among `t` frames."""
    c = min(t, context)
    return c * (c + 1) // 2 + (t - c) * context


def frames(cfg: dict, samples: int) -> int:
    """The transformers' frames (the SEANet's rate) of `samples` samples."""
    return samples // math.prod(cfg["encoder_rates"])


def codec_layers(cfg: dict, batch: int, samples: int):
    """-> (encoder layers, decoder layers) of the Mimi layout of `cfg` (the
    configuration file's ``codec`` block) at `samples` samples (a multiple
    of the frame)."""
    enc, dec = [], []
    t, d = samples, cfg["encoder_dim"]
    enc.append(("conv", 1, d, 7, t))
    for rate in cfg["encoder_rates"]:
        enc += [("conv", d, d // 2, 3, t), ("conv", d // 2, d, 1, t)]
        t //= rate
        enc.append(("conv", d, 2 * d, 2 * rate, t))
        d *= 2
    latent, s = cfg["latent_dim"], cfg["resample_stride"]
    enc += [("conv", d, latent, 3, t), ("conv", latent, latent, 2 * s, t // s)]
    dec += [("tconv", latent, latent, 2 * s, t, s, latent), ("conv", latent, cfg["decoder_dim"], 7, t)]
    d = cfg["decoder_dim"]
    for rate in cfg["decoder_rates"]:
        dec.append(("tconv", d, d // 2, 2 * rate, t * rate, rate, 1))
        t, d = t * rate, d // 2
        dec += [("conv", d, d // 2, 3, t), ("conv", d // 2, d, 1, t)]
    dec.append(("conv", d, 1, 3, t))
    return [(batch,) + e for e in enc], [(batch,) + e for e in dec]


def conv_flops(layers) -> float:
    """2 x MACs of the convs and transposed convs among `layers` (a
    transposed conv: c_in / groups x k / stride MACs an output sample)."""
    total = 0.0
    for e in layers:
        if e[1] == "conv":
            b, _, cin, cout, k, t = e
            total += 2.0 * b * t * cout * cin * k
        elif e[1] == "tconv":
            b, _, cin, cout, k, t, s, g = e
            total += 2.0 * b * t * cout * (cin // g) * k / s
    return total


def transformer_counts(cfg: dict, batch: int, samples: int) -> tuple[float, float]:
    """-> (FLOPs, bytes) of both transformers at `samples` samples."""
    t, c, f = frames(cfg, samples), cfg["latent_dim"], cfg["tfm_ffn"]
    rows, pairs = batch * t, batch * window_pairs(t, cfg["tfm_context"])
    flops = 2.0 * rows * (4 * c * c + 2 * c * f) + 4.0 * pairs * c
    # in_proj: y, W -> qkv; attention: q, k, v -> o; out_proj: o, W -> y; fc1: y, W -> h; fc2: h, W -> y
    elems = (rows * (c + 3 * c) + 3 * c * c) + rows * (3 * c + c) + (rows * 2 * c + c * c) \
        + (rows * (c + f) + c * f) + (rows * (f + c) + f * c)
    layers = 2 * cfg["tfm_layers"]
    return layers * flops, layers * elems * DTYPE_BYTES[cfg["compute_dtype"]]


def rvq_flops(cfg: dict, batch: int, samples: int) -> float:
    """Both quantizers' projections in and out and each used level's
    distances (2 D K FLOPs a frame)."""
    n = batch * samples // (math.prod(cfg["encoder_rates"]) * cfg["resample_stride"])
    c, d, k = cfg["latent_dim"], cfg["codebook_dim"], cfg["codebook_size"]
    return 2.0 * n * (2 * 2 * c * d + cfg["n_q"] * k * d)
