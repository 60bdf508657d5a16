from .api import MODELS, CodecState, codec_from_flax, load_codec, make_codec
from .mimi import MimiCodec
from .model import Decoder, Encoder, ResidualVQ, SnacCodec, VQLevel

__all__ = [
    "SnacCodec", "MimiCodec", "Encoder", "Decoder", "ResidualVQ", "VQLevel",
    "CodecState", "MODELS", "make_codec", "load_codec", "codec_from_flax",
]
