"""ms per call in the codec's decoder: the device time of the program's
``codec.decode`` spans (``codec/model.Decoder.forward``) in the traced
window, per ``entry.call``."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.decode", "entry.call")
