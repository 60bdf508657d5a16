from .config import (CodecConfig, MelConfig, NeuralWMConfig, SemanticWMConfig,
                     SpreadSpectrumConfig, StftConfig)
from .device import resolve_device
from . import audio_io
from .padding import bucket_length, fix_length, length_mask, pad_axis_to, pad_to_multiple

__all__ = [
    "CodecConfig",
    "MelConfig",
    "NeuralWMConfig",
    "SemanticWMConfig",
    "SpreadSpectrumConfig",
    "StftConfig",
    "resolve_device",
    "bucket_length",
    "fix_length",
    "pad_axis_to",
    "pad_to_multiple",
    "length_mask",
    "audio_io",
]
