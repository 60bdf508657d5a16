"""The binding of ``csrc/same_conv.cu``: the codec's stride-1 bfloat16
convolutions with SAME padding, the bias and an optional residual add, in
one launch.  ``ops/conv.py`` chooses it for the convs in :func:`takes`
(bfloat16, stride 1, one group, odd k <= 7, padding d (k - 1) / 2 <= 32,
C_in and C_out multiples of 16), and holds its plain version and its
gradient.  :func:`launch` sends a conv that :func:`gemm_path` admits (k 1,
T a multiple of 8, x, the residual and the output 16-byte aligned) to the
file's k = 1 GEMM kernel (counted as ``launches.k1conv``), every other
one to its stencil kernel (``launches.same_conv``).
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "same_conv", "nawc_same_conv",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
))
_K1 = _lib.register(_lib.CudaKernel(
    "k1conv", "nawc_k1conv",
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
))
_NULL = ctypes.c_void_p(None)
MAX_K, MAX_PAD = 7, 32  # the kernel's shared-memory tile holds these taps and halo


def takes(x: torch.Tensor, c_in: int, c_out: int, k: int, stride: int, dilation: int,
          groups: int) -> bool:
    """Whether the kernel computes a conv of these settings on `x`."""
    return (x.dtype == torch.bfloat16 and stride == 1 and groups == 1 and k % 2 == 1
            and k <= MAX_K and dilation * (k - 1) // 2 <= MAX_PAD and c_in % 16 == 0
            and c_out % 16 == 0)


def gemm_path(x: torch.Tensor, residual: torch.Tensor | None, out: torch.Tensor, k: int) -> bool:
    """Whether the k = 1 GEMM kernel takes a conv of :func:`takes` that
    writes `out`: k 1, and TMA's terms: T a multiple of 8 (16-byte rows),
    x, the residual and `out` 16-byte aligned."""
    if k != 1 or x.shape[-1] % 8:
        return False
    return (x.data_ptr() | out.data_ptr() | (0 if residual is None else residual.data_ptr())) % 16 == 0


def _tables(weight: torch.Tensor, bias: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor]:
    """The kernel's weights (k, C_out, C_in) bfloat16 and bias (C_out,)
    float32 of bfloat16 values (zero for a conv without bias, which adds
    nothing), kept until the parameters change."""
    def make():
        with torch.no_grad():
            w = weight.detach().to(torch.bfloat16).permute(2, 0, 1).contiguous()
            b = (torch.zeros(weight.shape[0], device=weight.device) if bias is None
                 else bias.detach().to(torch.bfloat16).float().contiguous())
        return w, b

    return _lib.derived(weight, "same_conv", [t for t in (weight, bias) if t is not None], make)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, residual: torch.Tensor | None,
           dilation: int) -> None:
    c_out, c_in, k = weight.shape
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        raise ValueError(f"same_conv: expected a bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"same_conv: weight on {weight.device}, bias on "
                         f"{None if bias is None else bias.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[1] != c_in:
        raise ValueError(f"same_conv: x {tuple(x.shape)} for a weight of {c_in} input channels")
    if not takes(x, c_in, c_out, k, 1, dilation, 1):
        raise ValueError(f"same_conv: the kernel does not take C_in {c_in}, C_out {c_out}, k {k}, "
                         f"dilation {dilation}")
    if residual is not None and (residual.shape != (x.shape[0], c_out, x.shape[2])
                                 or residual.dtype != x.dtype or residual.device != x.device):
        raise ValueError(f"same_conv: residual {tuple(residual.shape)} {residual.dtype} for an output "
                         f"of {(x.shape[0], c_out, x.shape[2])}")


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           residual: torch.Tensor | None, dilation: int) -> torch.Tensor:
    """The kernel's conv of a (B, C_in, T) bfloat16 CUDA tensor with the
    (C_out, C_in, k) weight and (C_out,) bias (or none), plus `residual`
    (B, C_out, T) where given, in one launch (x and the residual made
    contiguous; the weights laid out once per weight version); raises
    outside :func:`takes`."""
    x = x.contiguous()
    residual = None if residual is None else residual.contiguous()
    _check(x, weight, bias, residual, dilation)
    c_out, c_in, k = weight.shape
    b, _, t = x.shape
    out = torch.empty((b, c_out, t), dtype=x.dtype, device=x.device)
    if out.numel():
        w_p, b_f = _tables(weight, bias)
        ptrs = (_lib.ptr(x), _lib.ptr(w_p), _lib.ptr(b_f), _NULL if residual is None else _lib.ptr(residual),
                _lib.ptr(out))
        with torch.cuda.device(x.device):
            if gemm_path(x, residual, out, k):
                _K1(*ptrs, b, c_in, c_out, t, _lib.stream(x))
            else:
                _KERNEL(*ptrs, b, c_in, c_out, t, k, dilation, _lib.stream(x))
    return out


def bound_counts(b: int, c_in: int, c_out: int, t: int, k: int, residual: bool) -> tuple[float, float]:
    """-> (bytes, FLOPs) one call needs: x read and the output written once
    (and the residual read), the weights and bias read once; 2 C_in k FLOPs
    an output."""
    nbytes = 2.0 * b * t * (c_in + c_out * (2 if residual else 1)) + 2.0 * k * c_in * c_out + 4.0 * c_out
    return nbytes, 2.0 * b * t * c_out * c_in * k
