"""ms per call in the bfloat16 codecs: the device time of the program's
``codec.k1conv`` spans (``codec/layers.SameConv1d`` at k 1, stride 1, one
group: the ResidualUnits' Conv_1, SNAC's decoder head and noise-block convs)
in the traced window, per ``entry.call``; none where the program has no
such span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.k1conv", "entry.call")
