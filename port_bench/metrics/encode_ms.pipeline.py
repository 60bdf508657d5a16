"""ms per call in the codec's encoder: the device time of the program's
``codec.encode`` spans (``codec/model.Encoder.forward``) in the traced
window, per ``entry.call``."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.encode", "entry.call")
