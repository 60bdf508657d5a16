"""Launches of ``csrc/outconv.cu`` (the decoders' last conv) per call: the
program's ``launches.outconv`` counter over the traced window's
``entry.call`` spans; none where the program has no such kernel."""

from port_bench import program


def read(rec):
    return program.per_call(rec, "launches.outconv")
