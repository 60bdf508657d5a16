from . import jaxrand
from ._lib import KERNELS, plain_versions, reset_launches
from .rvq import nearest_codebook, nearest_codebook_reference
from .rvq_fused import rvq_encode_fused, rvq_encode_reference
from .snake import snake, snake_backward_reference, snake_reference
from .sswm import whiten_correlate, whiten_correlate_reference

__all__ = [
    "KERNELS",
    "jaxrand",
    "plain_versions",
    "reset_launches",
    "nearest_codebook",
    "nearest_codebook_reference",
    "rvq_encode_fused",
    "rvq_encode_reference",
    "snake",
    "snake_backward_reference",
    "snake_reference",
    "whiten_correlate",
    "whiten_correlate_reference",
]
