"""The binding of ``csrc/outconv.cu``: the codecs' output conv, C channels
to one at stride 1 (the decoders' last conv), computed in float32 from the
activation where it lies, bfloat16 or float32, with the bias.
``ops/conv.py`` chooses it for a conv asked to widen (``conv1d(...,
widen=True)``) that :func:`takes` admits; its plain version is the route it
replaces there, ``x.float()`` and then the float32 conv at its padding.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "outconv", "nawc_outconv",
    [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
))
_NULL = ctypes.c_void_p(None)
MAX_C = 1024  # the kernel's taps, (C, k) float32, sit in shared memory
KS = (3, 7)  # the taps of the four decoders' last convs


def takes(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, stride: int, dilation: int,
          groups: int, pads: tuple[int, int]) -> bool:
    """Whether the kernel computes the conv of `x` widened to float32 with
    the (C_out, C_in / groups, k) `weight` and `bias`, padded by `pads`
    (left, right) zeros: x bfloat16 or float32, contiguous, 16-byte aligned,
    of a T that is a multiple of 8 (a decoder's, frames times the hop);
    float32 weights and bias, C_out 1, C_in at most 1024, k 3 or 7, stride
    1, one group, dilation 1, pads summing to k - 1 (SAME's, a causal one)."""
    c_out, c_in, k = weight.shape
    left, right = pads
    return (x.dtype in (torch.bfloat16, torch.float32) and x.is_contiguous() and x.shape[-1] % 8 == 0
            and x.data_ptr() % 16 == 0 and weight.dtype == torch.float32
            and (bias is None or bias.dtype == torch.float32) and c_out == 1 and 1 <= c_in <= MAX_C
            and k in KS and stride == 1 and groups == 1 and dilation == 1
            and left >= 0 and right >= 0 and left + right == k - 1)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, left: int) -> None:
    k = weight.shape[-1]
    if x.dim() != 3 or x.shape[1] != weight.shape[1] or (bias is not None and bias.shape != (1,)):
        raise ValueError(f"outconv: x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}")
    if not takes(x, weight, bias, 1, 1, 1, (left, k - 1 - left)):
        raise ValueError(f"outconv: the kernel does not take x {x.dtype}, weight {tuple(weight.shape)} "
                         f"{weight.dtype}, left pad {left}")
    if not x.is_cuda or weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"outconv: x on {x.device}, weight on {weight.device}, bias on "
                         f"{None if bias is None else bias.device}: expected one CUDA device")


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, left: int) -> torch.Tensor:
    """The kernel's float32 conv of a (B, C, T) CUDA tensor with the (1, C,
    k) weight and (1,) bias (or none), padded by `left` zeros on the left
    and k - 1 - `left` on the right -> (B, 1, T) float32; raises outside
    :func:`takes`."""
    _check(x, weight, bias, left)
    b, c, t = x.shape
    out = torch.empty((b, 1, t), dtype=torch.float32, device=x.device)
    if out.numel():
        w = weight.detach().contiguous()
        bias = None if bias is None else bias.detach().contiguous()
        with torch.cuda.device(x.device):
            _KERNEL(_lib.ptr(x), x.element_size(), _lib.ptr(w), _NULL if bias is None else _lib.ptr(bias),
                    _lib.ptr(out), b, c, t, weight.shape[-1], left, _lib.stream(x))
    return out


def bound_bytes(b: int, c: int, t: int, k: int, elem_bytes: int) -> float:
    """The bytes one call needs, which bound it (about 2 k FLOPs an x value
    against its `elem_bytes`): x read and the float32 output written once,
    the taps and bias read once."""
    return float(b * c * t * elem_bytes + 4 * b * t + 4 * (c * k + 1))
