"""The whole call's share of the card's peak: the FLOPs a call needs
(``counts``: the codec's convolutions at the padded length and the
watermark's transforms and correlations) times the calls profiled, over the
profiled window's wall time, against the peak of the configuration's
compute type (67 TFLOP/s float32, 989 bfloat16)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof.get("unit") != "call" or "flops" not in rec.get("work", {}):
        return None
    return 100.0 * rec["work"]["flops"] * prof["units"] / prof["window_s"] / rec["work"]["peak_flops"]
