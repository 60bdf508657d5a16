"""Nearest-codebook lookup, the residual-VQ hot op (``nawc_tpu/ops/rvq.py``):
the CUDA kernel ``csrc/rvq.cu`` and its plain PyTorch version.

Lookup metric: cosine similarity over L2-normalised vectors; ties go to the
first index, as ``jnp.argmax`` and ``torch.argmax`` give.

:func:`nearest_euclidean` is Mimi's lookup (D 256, K 2048): the least
Euclidean distance, in float32 without TF32; on the card by cuBLAS, on the
CPU by its plain version.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _lib

_KERNEL = _lib.register(_lib.CudaKernel(
    "nearest_codebook", "nawc_nearest_codebook",
    [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
))
_KERNEL_DIMS = (8, 16, 32)  # template instances in csrc/rvq.cu


def _l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    """``x * rsqrt(sum(x^2) + eps)``, exactly as the JAX package (not
    ``F.normalize``, which clamps the norm instead)."""
    return x * torch.rsqrt((x * x).sum(dim=dim, keepdim=True) + eps)


def kernel_dim(d: int) -> int:
    """The kernel instance a D-wide vector is zero-padded to."""
    for kd in _KERNEL_DIMS:
        if d <= kd:
            return kd
    raise ValueError(f"the CUDA codebook kernels take D <= {_KERNEL_DIMS[-1]}, got {d}")


def nearest_codebook_reference(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(N, D), (K, D) -> (N,) int32 nearest (cosine) codebook indices."""
    scores = _l2_normalize(z) @ _l2_normalize(codebook).T
    return torch.argmax(scores, dim=-1).to(torch.int32)


def _nearest_codebook_cuda(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    n, d = z.shape
    k = codebook.shape[0]
    if codebook.shape[1] != d:
        raise ValueError(f"nearest_codebook: z is {tuple(z.shape)}, codebook {tuple(codebook.shape)}")
    codes = torch.empty(n, device=z.device, dtype=torch.int32)
    if n == 0:
        return codes
    dp = kernel_dim(d)
    z = z.detach().float().contiguous()
    cn = _lib.derived(codebook, "nearest_codebook", [codebook], lambda: F.pad(
        _l2_normalize(codebook.detach().float()), (0, dp - d)).contiguous())
    _lib.check_cuda_f32("nearest_codebook", z, cn)
    with torch.cuda.device(z.device):
        _KERNEL(_lib.ptr(z), _lib.ptr(cn), _lib.ptr(codes), n, k, d, dp, _lib.stream(z))
    return codes


def nearest_codebook(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-codebook indices for a batch of frames.

    Args:
      z: (..., D) query vectors (any leading shape; flattened internally).
      codebook: (K, D) codebook.  The kernel normalises it once and keeps
        the result until the codebook changes.

    Returns:
      (...,) int32 codes.  No gradient flows through the lookup.
    """
    lead = z.shape[:-1]
    zf = z.detach().reshape(-1, z.shape[-1])
    if _lib.use_kernel(zf):
        codes = _nearest_codebook_cuda(zf, codebook)
    else:
        codes = nearest_codebook_reference(zf, codebook.detach())
    return codes.reshape(lead)


def nearest_euclidean_reference(z: torch.Tensor, codebook: torch.Tensor, rows: int = 256) -> torch.Tensor:
    """(N, D), (K, D) -> (N,) int32 codes at the least exact ||z - c||^2
    (float32, the differences squared and summed), ties to the first index;
    `rows` frames at a time."""
    z, c = z.detach().float(), codebook.detach().float()
    out = [((zb[:, None, :] - c[None]) ** 2).sum(-1).argmin(-1) for zb in torch.split(z, rows)]
    return (torch.cat(out) if out else z.new_zeros(0, dtype=torch.long)).to(torch.int32)


def _nearest_euclidean_cuda(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """||c||^2 - 2 z.c by one cuBLAS product (TF32 off), the norms kept
    per codebook version, then argmin (the first index on ties)."""
    norms = _lib.derived(codebook, "euclidean_norms", [codebook],
                         lambda: codebook.detach().float().pow(2).sum(-1))
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dist = torch.addmm(norms, z.detach().float(), codebook.detach().float().T, alpha=-2.0)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return dist.argmin(dim=-1).to(torch.int32)


def nearest_euclidean(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., D) queries, (K, D) codebook -> (...,) int32 codes at the least
    Euclidean distance, ties to the first index; no gradient flows.  On the
    card ||c||^2 - 2 z.c by cuBLAS (:func:`_nearest_euclidean_cuda`), on the
    CPU and under ``plain_versions()`` the exact distances."""
    lead = z.shape[:-1]
    zf = z.detach().reshape(-1, z.shape[-1])
    if codebook.shape[-1] != zf.shape[-1]:
        raise ValueError(f"nearest_euclidean: z is {tuple(z.shape)}, codebook {tuple(codebook.shape)}")
    if _lib.use_kernel(zf):
        codes = _nearest_euclidean_cuda(zf, codebook)
    else:
        codes = nearest_euclidean_reference(zf, codebook)
    return codes.reshape(lead)


def score_margin(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """(..., D) -> (...,) gap between the best and second-best cosine score
    of the plain version: where it is tiny, two codes are near-tied and
    summation order alone may pick either."""
    scores = _l2_normalize(z.detach()) @ _l2_normalize(codebook.detach()).T
    top2 = torch.topk(scores, 2, dim=-1).values
    return top2[..., 0] - top2[..., 1]


def bound_counts(n: int, k: int, d: int) -> tuple[float, float]:
    """-> (bytes, flops) that ``nearest_codebook`` needs: frames, codebook
    and codes once each; one multiply-add per (frame, code, dim)."""
    return 4.0 * (n * d + k * d + n), 2.0 * n * k * d
