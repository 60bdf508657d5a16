"""Padding utilities (``nawc_tpu/utils/padding.py``), on torch tensors."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def padded_length(length: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= length."""
    return int(-(-length // multiple) * multiple)


def pad_axis_to(x: torch.Tensor, target: int, axis: int = -1) -> torch.Tensor:
    """Right-pad with zeros (or truncate) `axis` to exactly `target`."""
    size = x.shape[axis]
    if size == target:
        return x
    if size > target:
        return x.narrow(axis, 0, target)
    axis = axis % x.ndim
    # F.pad lists (left, right) pairs from the last axis backwards
    pads = [0, 0] * (x.ndim - 1 - axis) + [0, target - size]
    return F.pad(x, pads)


def pad_to_multiple(x: torch.Tensor, multiple: int, axis: int = -1) -> torch.Tensor:
    """Right-pad `x` with zeros along `axis` to a multiple of `multiple`."""
    return pad_axis_to(x, padded_length(x.shape[axis], multiple), axis=axis)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) int lengths -> (B, max_len) float32 {0, 1} validity mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return (pos < lengths[:, None]).to(torch.float32)


def fix_length(x: torch.Tensor, target: int, axis: int = -1) -> torch.Tensor:
    """Trim-or-pad to an exact length (the post-attack length fix-up)."""
    return pad_axis_to(x, target, axis=axis)


def bucket_length(length: int, buckets: tuple[int, ...]) -> int:
    """Pick the smallest bucket >= length."""
    for b in buckets:
        if length <= b:
            return b
    return padded_length(length, buckets[-1])


def ensure_mono_np(wav: np.ndarray) -> np.ndarray:
    """Collapse (C, T) or (T, C) numpy audio to mono (T,) by the channel
    mean; a first axis of at most 8 that is shorter than the second is
    the channel axis."""
    wav = np.asarray(wav)
    if wav.ndim == 1:
        return wav
    if wav.ndim == 2:
        if wav.shape[0] <= 8 and wav.shape[0] < wav.shape[1]:
            return wav.mean(axis=0)
        return wav.mean(axis=1)
    raise ValueError(f"unsupported audio shape {wav.shape}")
