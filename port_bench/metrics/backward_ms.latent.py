"""ms per Adam step in the codec-latent embed's backward (the encoder's
input gradient, the Snake's backward): the device time of the program's
``semantic.backward`` spans in the traced window, per span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "semantic.backward", "semantic.backward")
