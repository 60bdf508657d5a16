"""Device idle ms per call put down to the codec attack: the profiled
window's gaps between device operations whose ending operation the program
launched inside ``attack.codec`` (gain, pad, length fix) or a ``codec.*``
span."""

from port_bench import program


def read(rec):
    return program.idle_ms_per_call(rec, lambda name: name == "attack.codec" or name.startswith("codec."))
