"""Operations and bytes that the SNAC codec's work needs, from shapes, with
the yardstick of ``counts.py``: each input byte read once and each output
byte written once, whatever a kernel reads again.

:func:`codec_layers` lists the codec's layers at a (batch, samples) input,
encoder first, as tuples (batch, kind, ...):

* ("conv", c_in, c_out, k, t_out): a dense conv (k1 convs, the noise blocks'
  too, the strided convs, the first and last convs);
* ("dwconv", c, k, t): a depthwise conv;
* ("tconv", c_in, c_out, k, t_out, stride): a transposed conv;
* ("snake", c, t);
* ("attn", d, t, window): LocalMHA (its projections and its windows'
  products).
"""

from __future__ import annotations

from port_bench.counts import DTYPE_BYTES


def codec_layers(cfg: dict, batch: int, samples: int):
    """-> (encoder layers, decoder layers) of the SNAC layout of `cfg` (the
    configuration file's ``codec`` block) at `samples` padded samples."""
    enc, dec = [], []
    t, d = samples, cfg["encoder_dim"]
    win = cfg["attn_window"]

    def unit(out, c, t):
        out += [("snake", c, t), ("dwconv", c, 7, t), ("snake", c, t), ("conv", c, c, 1, t)]

    enc.append(("conv", 1, d, 7, t))
    for rate in cfg["encoder_rates"]:
        for _ in range(3):
            unit(enc, d, t)
        t //= rate
        enc += [("snake", d, t * rate), ("conv", d, 2 * d, 2 * rate, t)]
        d *= 2
    enc += [("attn", d, t, win), ("dwconv", d, 7, t)]
    dec += [("dwconv", d, 7, t), ("conv", d, cfg["decoder_dim"], 1, t)]
    d = cfg["decoder_dim"]
    dec.append(("attn", d, t, win))
    for rate in cfg["decoder_rates"]:
        dec += [("snake", d, t), ("tconv", d, d // 2, 2 * rate, t * rate, rate)]
        t, d = t * rate, d // 2
        dec.append(("conv", d, d, 1, t))  # the noise block's
        for _ in range(3):
            unit(dec, d, t)
    dec += [("snake", d, t), ("conv", d, 1, 7, t)]
    return [(batch,) + e for e in enc], [(batch,) + e for e in dec]


def conv_flops(layers) -> float:
    """2 x MACs of the dense, depthwise and transposed convs among `layers`
    (a transposed conv: c_in k / stride MACs an output sample)."""
    total = 0.0
    for e in layers:
        b, kind = e[0], e[1]
        if kind == "conv":
            _, _, cin, cout, k, t = e
            total += 2.0 * b * t * cout * cin * k
        elif kind == "dwconv":
            _, _, c, k, t = e
            total += 2.0 * b * t * c * k
        elif kind == "tconv":
            _, _, cin, cout, k, t, s = e
            total += 2.0 * b * t * cout * cin * k / s
    return total


def attention_flops(layers) -> float:
    """LocalMHA's products: q, k, v (2 t d 3d), the scores and their
    weighted sum inside each window (2 x 2 t window d), the output (2 t d d)."""
    total = 0.0
    for e in layers:
        if e[1] == "attn":
            b, _, d, t, w = e
            total += 2.0 * b * t * (3 * d * d + 2 * w * d + d * d)
    return total


def dwconv_bytes(layers, dtype: str) -> float:
    """Bytes the depthwise convs need: x read and y written once, the
    weight and bias read once, in the compute type."""
    n = DTYPE_BYTES[dtype]
    return sum(2.0 * n * e[0] * e[2] * e[4] + n * e[2] * (e[3] + 1)
               for e in layers if e[1] == "dwconv")
