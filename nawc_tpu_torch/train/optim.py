"""The optax transformations the JAX trainers build, as optax computes them.

* :func:`clip_by_global_norm_` is ``optax.clip_by_global_norm``: the
  gradients are scaled as ``(g / norm) * max_norm`` only when the global
  norm reaches `max_norm`, with no epsilon (``clip_grad_norm_`` adds 1e-6);
* :func:`warmup_cosine_decay_schedule` is optax's schedule of the same name,
  evaluated at optax's count: 0 at the first update;
* :class:`AdamW` is ``optax.chain(clip_by_global_norm(max_norm),
  adamw(schedule, b1, b2, eps, weight_decay))`` over the parameters it is
  given.  Adam's moments and the decoupled weight decay (on every leaf,
  biases included, from the parameter before the update) are
  ``torch.optim.AdamW``'s, in any of its forms (for-loop, ``foreach`` or
  ``fused``); optax rounds its bias corrections to float32, torch keeps them
  in float64, so an update may differ from optax's in its last bits.  The
  fused form writes the parameters without moving their version counters
  (PyTorch 2.11 on an H100), and a kernel's table cached from a tensor is
  keyed on its version (``ops/_lib.derived``: the lookup's normalised
  codebook), so :meth:`AdamW.step` moves them itself.

A frozen part of a model (``multi_transform`` with ``set_to_zero``, as the
GAN trainer freezes the encoder and the quantizer) is one that is not given
to :class:`AdamW`: it is neither clipped, decayed nor moved.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import torch
from torch.autograd.graph import increment_version


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares of every entry (``optax.global_norm``)."""
    return torch.sqrt(torch.stack([torch.sum(g * g) for g in grads]).sum())


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float) -> torch.Tensor:
    """Scale `grads` in place as ``optax.clip_by_global_norm(max_norm)``
    does -> the global norm (before clipping).  No host sync."""
    norm = global_norm(grads)
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0) -> Callable[[int], float]:
    """optax's linear warmup from `init_value` to `peak_value` over
    `warmup_steps`, then cosine decay to `end_value` at `decay_steps`
    (warmup included)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cos_steps = decay_steps - warmup_steps
    if not cos_steps > 0:
        raise ValueError(f"the cosine decay needs positive decay steps, got {cos_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, cos_steps)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / cos_steps)) + alpha)

    return schedule


class AdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(lr, ...))`` over
    `params`; `lr` is a number or a schedule of optax's update count.

    Call :meth:`zero_grad` before the backward pass and :meth:`step` after
    it.  A parameter the loss did not reach gets a zero gradient, as in
    optax: its moments decay and its weight decay applies."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float | Callable[[int], float],
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8, weight_decay: float = 1e-4,
                 max_norm: float = 1.0, foreach: bool | None = None, fused: bool | None = None):
        self.params = list(params)
        self.schedule = lr if callable(lr) else (lambda count: lr)
        self.max_norm = max_norm
        self.count = 0
        self.opt = torch.optim.AdamW(self.params, lr=self.schedule(0), betas=(b1, b2), eps=eps,
                                     weight_decay=weight_decay, foreach=foreach, fused=fused)

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def step(self) -> torch.Tensor:
        """One update -> the gradients' global norm before clipping."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        norm = clip_by_global_norm_([p.grad for p in self.params], self.max_norm)
        for group in self.opt.param_groups:
            group["lr"] = float(self.schedule(self.count))
        self.opt.step()
        increment_version(self.params)
        self.count += 1
        return norm
