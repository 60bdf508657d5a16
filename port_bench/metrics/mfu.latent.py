"""An Adam step's share of the card's peak: the encoder's convolutions
forward and their input gradient (twice the forward's FLOPs) per step,
times the steps profiled, over the profiled window's wall time, against
67 TFLOP/s (float32)."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof.get("unit") != "step" or "flops" not in rec.get("work", {}):
        return None
    return 100.0 * rec["work"]["flops"] * prof["units"] / prof["window_s"] / rec["work"]["peak_flops"]
