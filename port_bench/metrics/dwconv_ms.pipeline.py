"""ms per call in the SNAC codec: the device time of the program's
``codec.dwconv`` spans (``codec/layers.SameConv1d`` with groups equal to its channels:
SNAC's depthwise k7 convs) in the traced window,
per ``entry.call``; none where the program has no such span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.dwconv", "entry.call")
