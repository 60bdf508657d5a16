"""Launches of the stride-1 convolution kernel (``csrc/same_conv.cu``) per
call: the program's ``launches.same_conv`` counter over the traced window's
``entry.call`` spans; none where the program has no such kernel."""

from port_bench import program


def read(rec):
    return program.per_call(rec, "launches.same_conv")
