"""ms per call in the SNAC codec: the device time of the program's
``codec.noise`` spans (``codec/layers.NoiseBlock``: its keyed draw, k1 conv and
product) in the traced window,
per ``entry.call``; none where the program has no such span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.noise", "entry.call")
