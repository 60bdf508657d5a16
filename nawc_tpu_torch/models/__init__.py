from .base import Watermarker, available, bit_accuracy, build, random_message, register
from .chunked import ChunkedWM
from .psychoacoustic import PsychoacousticWM, bits_to_ints, ints_to_bits
from .spread_spectrum import SpreadSpectrumWM

__all__ = [
    "Watermarker", "random_message", "bit_accuracy", "available", "build",
    "register", "SpreadSpectrumWM", "ChunkedWM", "PsychoacousticWM",
    "ints_to_bits", "bits_to_ints",
]
