"""Device ms per Adam step outside the convolutions and the port's
kernels: the loss, reductions, the spectral projection, Adam, copies."""

from port_bench import kinds


def read(rec):
    prof = rec.get("profile")
    if not prof or prof.get("unit") != "step":
        return None
    t = kinds.seconds(prof["ops"], lambda n: kinds.kind(n) == "other")
    return t / prof["units"] * 1e3 if t > 0 else None
