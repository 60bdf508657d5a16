"""ms per call in the spread-spectrum watermark: the synchronised spans
around embed and detect over the window, per call of the entry."""


def read(rec):
    spans = rec.get("spans", {})
    if "wm.embed" not in spans or not rec.get("calls"):
        return None
    return (sum(spans["wm.embed"]) + sum(spans.get("wm.detect", []))) / rec["calls"] * 1e3
