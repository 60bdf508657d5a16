"""The Snake kernels' share of their byte bound in the pipeline: the bytes
the forward Snakes of a call need (``counts.snake_bytes``) at 3.35 TB/s,
over their device time per call in the profiled window."""

from port_bench import counts


def read(rec):
    prof = rec.get("profile")
    if not prof or prof.get("unit") != "call" or "snake_bytes" not in rec.get("work", {}):
        return None
    t = sum(d for n, _, d in prof["ops"] if "snake_" in n) / 1e6
    if t <= 0:
        return None
    return 100.0 * rec["work"]["snake_bytes"] / counts.PEAK_BYTES_PER_S / (t / prof["units"])
