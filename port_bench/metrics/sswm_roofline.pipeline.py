"""``csrc/sswm.cu``'s share of its bound: the larger of its bytes at
3.35 TB/s and its operations at their units' peaks (``counts.sswm_counts``)
for the detects of one call, over the sswm kernels' device time per call."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof.get("unit") != "call" or "sswm_bound_s" not in rec.get("work", {}):
        return None
    t = sum(d for n, _, d in prof["ops"] if "sswm_" in n) / 1e6
    if t <= 0:
        return None
    return 100.0 * rec["work"]["sswm_bound_s"] / (t / prof["units"])
