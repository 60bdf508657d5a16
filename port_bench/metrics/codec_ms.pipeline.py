"""ms per call in the codec round trip (gain, pad, encode, quantize,
decode): the synchronised span around ``codec_roundtrip``, per call."""


def read(rec):
    spans = rec.get("spans", {})
    if "codec.roundtrip" not in spans or not rec.get("calls"):
        return None
    return sum(spans["codec.roundtrip"]) / rec["calls"] * 1e3
