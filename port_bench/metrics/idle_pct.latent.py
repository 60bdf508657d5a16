"""Share of the profiled window of Adam steps in which no device operation
runs."""


def read(rec):
    prof = rec.get("profile")
    if not prof or prof["busy_s"] <= 0 or prof.get("unit") != "step" or prof["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["busy_s"] / prof["window_s"])
