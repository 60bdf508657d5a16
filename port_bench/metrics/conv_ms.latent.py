"""Device ms per Adam step in cuDNN's convolution kernels (forward and
input gradient, with their layout transforms) in the profiled window."""

from port_bench import kinds


def read(rec):
    prof = rec.get("profile")
    if not prof or prof.get("unit") != "step":
        return None
    t = kinds.seconds(prof["ops"], lambda n: kinds.kind(n) == "conv")
    return t / prof["units"] * 1e3 if t > 0 else None
