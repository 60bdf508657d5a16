"""ms per call in the roundtrip cells: the device time of the program's
``codec.outconv`` spans (``codec/layers.SameConv1d`` with ``widen``: the
decoders' last conv, C channels to one in float32) in the traced window,
per ``entry.call``; none where the program has no such span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.outconv", "entry.call")
