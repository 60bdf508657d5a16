"""The depthwise convs' share of their byte bound in the pipeline: the bytes
they need (``counts_snac.dwconv_bytes``: x read and y written once) at 3.35
TB/s, over their device time per call (the program's ``codec.dwconv``
spans, per ``entry.call``); none without either, or where a span has no
device time (a run on the CPU)."""

from port_bench import counts, program


def read(rec):
    snap = program.snapshot(rec)
    nbytes = rec.get("work", {}).get("dwconv_bytes")
    if not snap or nbytes is None:
        return None
    ms = [s["device_ms"] for s in snap["spans"] if s["name"] == "codec.dwconv"]
    calls = sum(1 for s in snap["spans"] if s["name"] == "entry.call")
    if not ms or not calls or None in ms or sum(ms) <= 0:
        return None
    return 100.0 * nbytes / counts.PEAK_BYTES_PER_S / (sum(ms) / calls / 1e3)
