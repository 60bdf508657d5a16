"""The transformers' share of their bound in the pipeline: the larger of
their FLOPs at the configuration's peak (989 TFLOP/s bfloat16) and their
bytes at 3.35 TB/s (``counts_mimi.transformer_counts``: the projections,
the MLP and the windowed q k^T and p v; weights read once, each of those
ops' inputs read and outputs written once), over their device time per
call (the program's ``codec.transformer`` spans, per ``entry.call``); none
without either, or where a span has no device time (a run on the CPU)."""

from port_bench import program


def read(rec):
    snap = program.snapshot(rec)
    bound_s = rec.get("work", {}).get("tfm_bound_s")
    if not snap or bound_s is None:
        return None
    ms = [s["device_ms"] for s in snap["spans"] if s["name"] == "codec.transformer"]
    calls = sum(1 for s in snap["spans"] if s["name"] == "entry.call")
    if not ms or not calls or None in ms or sum(ms) <= 0:
        return None
    return 100.0 * bound_s / (sum(ms) / calls / 1e3)
