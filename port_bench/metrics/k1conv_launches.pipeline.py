"""Launches of the k = 1 GEMM path of ``csrc/same_conv.cu`` per call: the
program's ``launches.k1conv`` counter over the traced window's
``entry.call`` spans; none where the program has no such kernel."""

from port_bench import program


def read(rec):
    return program.per_call(rec, "launches.k1conv")
