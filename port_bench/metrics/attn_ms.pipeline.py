"""ms per call in the SNAC codec: the device time of the program's
``codec.attention`` spans (``codec/layers.LocalMHA``: its LayerNorm, projections, rotary
products and windowed attention) in the traced window,
per ``entry.call``; none where the program has no such span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.attention", "entry.call")
