"""ms per call in the Mimi codec: the device time of the program's
``codec.transformer`` spans (``codec/mimi.Transformer``: the encoder's and
the decoder's transformer, each layer's LayerNorms, projections, RoPE,
windowed attention, MLP, LayerScales and residuals) in the traced window,
per ``entry.call``; none where the program has no such span."""

from port_bench import program


def read(rec):
    return program.ms_per(rec, "codec.transformer", "entry.call")
