"""Bytes the program copies from host memory to the card per call: its
``copy.h2d_bytes`` counter (pattern tables, Hann windows) over the traced
window's ``entry.call`` spans."""

from port_bench import program


def read(rec):
    return program.per_call(rec, "copy.h2d_bytes")
