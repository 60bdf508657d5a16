"""Hamming(12,8) single-error-correcting code over GF(2)
(``nawc_tpu/utils/ecc.py``), on torch tensors.

It protects the psychoacoustic watermark's exact-match payload.  Layout: a
12-bit codeword with parity bits at the 1-indexed positions 1, 2, 4 and 8
covering the standard Hamming index sets, and the data bits in the other
positions in order.  The 4-bit syndrome is the 1-indexed position of a
single error (0 = clean).  The tables are built with numpy, as in JAX.
"""

from __future__ import annotations

import numpy as np
import torch

_N, _K = 12, 8
_PARITY_POS = (1, 2, 4, 8)  # 1-indexed
_DATA_POS = tuple(p for p in range(1, _N + 1) if p not in _PARITY_POS)


def _parity_checks() -> np.ndarray:
    """(4, 12) check matrix: row r covers the positions with bit r set."""
    h = np.zeros((4, _N), np.int32)
    for r in range(4):
        for pos in range(1, _N + 1):
            if pos & (1 << r):
                h[r, pos - 1] = 1
    return h


_H = _parity_checks()


def _all_codewords() -> np.ndarray:
    """(256, 12) codeword table enumerated by data byte (big-endian bits)."""
    data = (np.arange(256)[:, None] >> np.arange(7, -1, -1)) & 1
    cw = np.zeros((256, _N), np.int32)
    for i, pos in enumerate(_DATA_POS):
        cw[:, pos - 1] = data[:, i]
    for r, ppos in enumerate(_PARITY_POS):
        mask = _H[r].copy()
        mask[ppos - 1] = 0
        cw[:, ppos - 1] = (cw * mask).sum(axis=-1) % 2
    return cw


_CODEWORDS = _all_codewords()
_SHIFTS = tuple(range(7, -1, -1))


def hamming_encode(data: torch.Tensor) -> torch.Tensor:
    """(..., 8) data bits -> (..., 12) codeword bits (int32)."""
    cw = torch.zeros(data.shape[:-1] + (_N,), dtype=torch.int32, device=data.device)
    for i, pos in enumerate(_DATA_POS):
        cw[..., pos - 1] = data[..., i]
    h = torch.as_tensor(_H, device=data.device)
    for r, ppos in enumerate(_PARITY_POS):
        # parity over the covered positions, the parity bit itself excluded
        mask = h[r].clone()
        mask[ppos - 1] = 0
        cw[..., ppos - 1] = (cw * mask).sum(dim=-1) % 2
    return cw


def _byte_bits(byte: torch.Tensor) -> torch.Tensor:
    shifts = torch.tensor(_SHIFTS, device=byte.device)
    return ((byte[..., None] >> shifts) & 1).to(torch.int32)


def hamming_soft_decode(llr: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Maximum-likelihood soft decoding: (..., 12) soft statistics (positive =
    bit 1, magnitude = confidence) -> ((..., 8) data bits, (...,) byte).
    Correlates against all 256 codewords and takes the best, the first on
    ties as ``jnp.argmax`` does."""
    cw = torch.as_tensor(2.0 * _CODEWORDS - 1.0, dtype=llr.dtype, device=llr.device)
    score = torch.einsum("...n,kn->...k", llr, cw)
    byte = torch.argmax(score, dim=-1)
    return _byte_bits(byte), byte


def hamming_decode(code: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(..., 12) received bits -> ((..., 8) corrected data, (...,)
    n_corrected in {0, 1})."""
    h = torch.as_tensor(_H, device=code.device)
    weights = torch.tensor([1, 2, 4, 8], device=code.device)
    syndrome = torch.stack([(code * h[r]).sum(dim=-1) % 2 for r in range(4)], dim=-1)
    err_pos = (syndrome * weights).sum(dim=-1)
    onehot = (torch.arange(1, _N + 1, device=code.device) == err_pos[..., None]).to(torch.int32)
    corrected = (code + onehot) % 2
    data = torch.stack([corrected[..., pos - 1] for pos in _DATA_POS], dim=-1)
    return data.to(torch.int32), (err_pos > 0).to(torch.int32)
