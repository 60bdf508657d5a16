"""ms per call in the residual VQ: the device time of the program's
``codec.quantize`` spans (``codec/model.ResidualVQ``) in the traced window,
per ``entry.call``."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.quantize", "entry.call")
