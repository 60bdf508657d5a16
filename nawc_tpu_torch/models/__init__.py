from .base import Watermarker, available, bit_accuracy, build, random_message, register
from .chunked import ChunkedWM
from .neural import NeuralWM, WMDetector, WMGenerator, init_neural_wm, load_neural_wm
from .psychoacoustic import PsychoacousticWM, bits_to_ints, ints_to_bits
from .resampled import ResampledWM, at_rate
from .semantic import SemanticWM, kmeans_axis, pca_axis, random_axis
from .spread_spectrum import SpreadSpectrumWM
from .token_green import TokenGreenWM, green_mask

__all__ = [
    "Watermarker", "random_message", "bit_accuracy", "available", "build",
    "register", "SpreadSpectrumWM", "ChunkedWM", "PsychoacousticWM",
    "ints_to_bits", "bits_to_ints", "ResampledWM", "at_rate",
    "SemanticWM", "pca_axis", "kmeans_axis", "random_axis",
    "TokenGreenWM", "green_mask", "NeuralWM", "init_neural_wm", "load_neural_wm",
    "WMGenerator", "WMDetector",
]
