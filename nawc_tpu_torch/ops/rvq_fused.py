"""Fused multi-level residual-VQ encode (``nawc_tpu/ops/rvq_fused.py``): the
CUDA kernel ``csrc/rvq_fused.cu`` and its plain PyTorch version.

The unfused path (``codec/model.py: ResidualVQ.encode``) round-trips the
residual, projections, scores and dequantised contributions through device
memory between levels.  The kernel keeps a tile of 24 latent frames and a
level's codebook in one block's shared memory and runs pool -> in_proj ->
cosine argmax -> gather-dequantise -> out_proj -> residual subtract for
every level before it writes codes.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _lib
from .rvq import _l2_normalize, kernel_dim

_KERNEL = _lib.register(_lib.CudaKernel(
    "rvq_encode_fused", "nawc_rvq_encode",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
    + [ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_void_p],
))


def level_params(quantizer, i: int) -> tuple[torch.Tensor, ...]:
    """One VQ level's tables in the JAX package's layouts:
    in_proj kernel (D, C), bias (C,), out_proj kernel (C, D), bias (D,),
    codebook (K, C)."""
    lvl = getattr(quantizer, f"level_{i}")
    return (lvl.in_proj.weight.T, lvl.in_proj.bias,
            lvl.out_proj.weight.T, lvl.out_proj.bias, lvl.codebook)


def rvq_encode_reference(z: torch.Tensor, quantizer, strides) -> list[torch.Tensor]:
    """Plain mirror of ``ResidualVQ.encode`` on raw tables; the kernel's
    plain version and the CPU path."""
    res = z
    codes_out = []
    for i, s in enumerate(strides):
        in_k, in_b, out_k, out_b, cb = level_params(quantizer, i)
        b, t, d = res.shape
        pooled = res.reshape(b, t // s, s, d).mean(dim=2) if s > 1 else res
        z_e = pooled @ in_k + in_b
        scores = _l2_normalize(z_e) @ _l2_normalize(cb).T
        codes = torch.argmax(scores, dim=-1).to(torch.int32)
        out = cb[codes.long()] @ out_k + out_b
        if s > 1:
            out = torch.repeat_interleave(out, s, dim=1)
        res = res - out
        codes_out.append(codes)
    return codes_out


def _planes(x: torch.Tensor) -> torch.Tensor:
    """(L, N, Cp) -> (L, Cp/4, N, 4): plane q holds float4 q of every row."""
    n_lev, n, cp = x.shape
    return x.reshape(n_lev, n, cp // 4, 4).permute(0, 2, 1, 3).contiguous()


def pack_tables(quantizer, n_levels: int) -> tuple[torch.Tensor, ...]:
    """Stack every level's tables for the kernel, with the codebook width
    zero-padded to a kernel instance Cp: in_proj as float4 planes
    (L, Cp/4, D, 4), bias (L, Cp), out_proj (L, Cp, D), bias (L, D), the
    normalised codebook as float4 planes (L, Cp/4, K, 4) and the raw one
    (L, K, Cp)."""
    cols = [level_params(quantizer, i) for i in range(n_levels)]
    c = cols[0][4].shape[1]
    cp = kernel_dim(c)

    def stack(j, pad, fn=lambda x: x):
        return torch.stack([F.pad(fn(col[j].detach().float()), pad) for col in cols]).contiguous()

    return (_planes(stack(0, (0, cp - c))), stack(1, (0, cp - c)), stack(2, (0, 0, 0, cp - c)),
            stack(3, (0, 0)), _planes(stack(4, (0, cp - c), _l2_normalize)),
            stack(4, (0, cp - c)))


def packed_tables(quantizer, n_levels: int) -> tuple[torch.Tensor, ...]:
    """:func:`pack_tables`, packed once per quantizer and kept until one of
    its tables changes (:func:`_lib.derived`)."""
    params = [p for i in range(n_levels) for p in getattr(quantizer, f"level_{i}").parameters()]
    return _lib.derived(quantizer, f"rvq_fused/{n_levels}", params,
                        lambda: pack_tables(quantizer, n_levels))


def _rvq_encode_cuda(z: torch.Tensor, quantizer, strides) -> list[torch.Tensor]:
    b, t, d = z.shape
    z = z.detach().float().contiguous()
    tables = packed_tables(quantizer, len(strides))
    ink, inb, outk, outb, cbn, cbr = tables
    _lib.check_cuda_f32("rvq_encode_fused", z, *tables)
    sizes = [b * (t // s) for s in strides]
    codes = torch.empty(sum(sizes), device=z.device, dtype=torch.int32)
    strides_c = (ctypes.c_int * len(strides))(*strides)
    with torch.cuda.device(z.device):
        _KERNEL(*(_lib.ptr(x) for x in (z, ink, inb, outk, outb, cbn, cbr, codes)),
                b, t, d, cbr.shape[2], cbr.shape[1], strides_c, len(strides), _lib.stream(z))
    return [c.reshape(b, t // s) for c, s in zip(torch.split(codes, sizes), strides)]


MAX_LEVELS, TILE = 8, 24  # the kernel's level count and frame tile: every stride divides the tile


def takes(strides) -> bool:
    """Whether the kernel takes these levels' strides."""
    return len(strides) <= MAX_LEVELS and all(s >= 1 and TILE % s == 0 for s in strides)


def rvq_encode_fused(z: torch.Tensor, quantizer, strides) -> list[torch.Tensor]:
    """Full residual-VQ encode: z (B, T', D) -> per-level codes
    [(B, T'/s_i) int32].  ``quantizer`` is the codec's ``ResidualVQ``.

    T' must divide by every stride (the codec's pad-to-chunk rule ensures
    it).  A CUDA tensor runs the fused kernel on tables packed once per
    quantizer (:func:`packed_tables`); it takes up to 8 levels whose strides
    divide 24 (:func:`takes`), and raises on others.  A CPU tensor runs the
    plain version."""
    strides = tuple(int(s) for s in strides)
    if _lib.use_kernel(z):
        return _rvq_encode_cuda(z, quantizer, strides)
    with torch.no_grad():
        return rvq_encode_reference(z, quantizer, strides)


def bound_counts(b: int, t: int, d: int, c: int, k: int, strides) -> tuple[float, float]:
    """-> (bytes, flops) that the codes need: z, the codes and one copy of
    each level's tables once each (no out_proj for the last level, whose
    residual nobody reads); per level the pooling adds where the stride
    exceeds 1, the in_proj and cosine-score multiply-adds, and for every
    level but the last the out_proj multiply-adds and the residual subtract."""
    pooled = [b * (t // s) for s in strides]
    n_sub = len(strides) - 1  # levels whose residual update the codes need
    nbytes = 4.0 * (b * t * d + sum(pooled)
                    + len(strides) * (d * c + c + k * c) + n_sub * (c * d + d))
    flops = (sum(b * t * d for s in strides if s > 1)       # pooling adds
             + 2.0 * sum(pooled) * (d * c + k * c)           # in_proj, scores
             + 2.0 * sum(pooled[:n_sub]) * c * d             # out_proj
             + n_sub * b * t * d)                            # residual subtract
    return nbytes, flops
