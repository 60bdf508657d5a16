"""ms per Adam step in the codec-latent embed's update (gradient mask, Adam,
budget): the device time of the program's ``semantic.adam`` spans in the
traced window, per span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "semantic.adam", "semantic.adam")
