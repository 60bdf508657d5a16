"""Device operations by kind, from their names in the profiler's trace.

The port's kernels carry the names of ``nawc_tpu_torch/csrc/*.cu``;
cuDNN's convolution kernels and its layout transforms carry one of the
convolution marks (``sm90_xmma_fprop_implicit_gemm...``, ``...dgrad...``,
``nchwToNhwcKernel``)."""

from __future__ import annotations

PORT = ("snake_", "sswm_", "nearest_codebook", "rvq_encode", "keyed_kernel", "normal_of_bits")
CONV = ("conv", "xmma", "implicit_gemm", "fprop", "dgrad", "wgrad", "nchw", "nhwc", "cudnn")


def kind(name: str) -> str:
    n = name.lower()
    if any(k in n for k in PORT):
        return "port"
    if any(k in n for k in CONV):
        return "conv"
    return "other"


def seconds(ops, pred) -> float:
    """Summed device seconds of the operations whose name satisfies `pred`."""
    return sum(dur for name, _, dur in ops if pred(name)) / 1e6
