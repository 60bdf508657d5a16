"""Launches of the depthwise convolution kernel (``csrc/dwconv.cu``) per
call: the program's ``launches.dwconv`` counter over the traced window's
``entry.call`` spans; none where the program has no such kernel."""

from port_bench import program


def read(rec):
    return program.per_call(rec, "launches.dwconv")
