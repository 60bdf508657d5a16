"""ms per Adam step in the codec-latent embed's loss forward: the device
time of the program's ``semantic.loss`` spans in the traced window, per span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "semantic.loss", "semantic.loss")
