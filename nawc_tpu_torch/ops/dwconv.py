"""The binding of ``csrc/dwconv.cu``: the codec's depthwise (one group a
channel) stride-1 bfloat16 convolutions with SAME padding and the bias.
``ops/conv.py`` chooses it for the convs in :func:`takes` (bfloat16, stride
1, groups equal to the input and output channels, k 7 at dilation 1, 3 or
9: SNAC's geometries), and holds its plain version and its gradient.
"""

from __future__ import annotations

import ctypes

import torch

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "dwconv", "nawc_dwconv",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
))
_NULL = ctypes.c_void_p(None)
K, DILATIONS = 7, (1, 3, 9)  # the kernel's instantiations


def takes(x: torch.Tensor, c_in: int, c_out: int, k: int, stride: int, dilation: int,
          groups: int, pads: tuple[int, int]) -> bool:
    """Whether the kernel computes a conv of these settings on `x`, padded
    by `pads` (left, right) zeros: SAME's d (k - 1) / 2 on both sides."""
    return (x.dtype == torch.bfloat16 and stride == 1 and groups == c_in == c_out
            and k == K and dilation in DILATIONS and pads == (dilation * (k - 1) // 2,) * 2)


def _tables(weight: torch.Tensor, bias: torch.Tensor | None) -> tuple[torch.Tensor, torch.Tensor | None]:
    """The kernel's taps (C, k) and bias (C,) (None without one), float32
    of bfloat16 values, kept until the parameters change."""
    def make():
        with torch.no_grad():
            w = weight.detach().to(torch.bfloat16).float().reshape(weight.shape[0], -1).contiguous()
            b = None if bias is None else bias.detach().to(torch.bfloat16).float().contiguous()
        return w, b

    return _lib.derived(weight, "dwconv", [t for t in (weight, bias) if t is not None], make)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None, dilation: int,
           left: int) -> None:
    c, _, k = weight.shape
    if x.dtype != torch.bfloat16 or not x.is_cuda:
        raise ValueError(f"dwconv: expected a bfloat16 CUDA tensor, got {x.dtype} on {x.device}")
    if weight.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError(f"dwconv: weight on {weight.device}, bias on "
                         f"{None if bias is None else bias.device}, x on {x.device}")
    if x.dim() != 3 or x.shape[1] != c or weight.shape[1] != 1 or (bias is not None and bias.shape != (c,)):
        raise ValueError(f"dwconv: x {tuple(x.shape)}, weight {tuple(weight.shape)}, bias "
                         f"{None if bias is None else tuple(bias.shape)}: not a depthwise conv")
    if not takes(x, c, c, k, 1, dilation, c, (left, dilation * (k - 1) - left)):
        raise ValueError(f"dwconv: the kernel does not take k {k}, dilation {dilation}, left pad {left}")


def launch(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
           residual: torch.Tensor | None, dilation: int, left: int) -> torch.Tensor:
    """The kernel's conv of a (B, C, T) bfloat16 CUDA tensor (made
    contiguous) padded by `left` zeros on the left and d (k - 1) - `left` on
    the right (SAME's d (k - 1) / 2 alone is taken), plus `residual` where
    given (added after it, in bfloat16); raises outside :func:`takes`."""
    x = x.contiguous()
    _check(x, weight, bias, dilation, left)
    b, c, t = x.shape
    out = torch.empty_like(x)
    if out.numel():
        w_t, b_t = _tables(weight, bias)
        with torch.cuda.device(x.device):
            _KERNEL(_lib.ptr(x), _lib.ptr(w_t), _NULL if b_t is None else _lib.ptr(b_t), _lib.ptr(out),
                    b, c, t, weight.shape[-1], dilation, _lib.stream(x))
    return out if residual is None else residual + out


def bound_bytes(b: int, c: int, t: int, k: int) -> float:
    """The bytes one call needs, which bound it (2 k FLOPs an output against
    4 bytes): x read and the output written once, the taps and bias read
    once, in bfloat16 (``counts_snac.dwconv_bytes``' yardstick)."""
    return 4.0 * b * c * t + 2.0 * c * (k + 1)
