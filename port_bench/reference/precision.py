"""Arithmetic precisions of the reference, emulated by rounding.

A :class:`Precision` rounds the operands of every convolution and product
(``operand``), the activations that the configuration stores between
layers (``store``), the operands of what a configuration keeps in float32
(``wide``: the residual VQ, the decoder's last conv, the watermark's
products) and the watermark's signal path (``dsp``: the transforms' inputs
and outputs, the log-magnitudes).  The arithmetic itself is float32,
accumulated in float32, with TF32 off.  The roundings:

* TF32: the 10-bit mantissa, to nearest with ties away from zero, as the
  tensor cores convert float32;
* bfloat16;
* float8 e4m3 with one scale per tensor (its largest magnitude to 448).

``float32`` rounds nothing and ``bfloat16`` operands and activations (the
two configurations).  A control lowers each part to the precision next
below the configuration's: ``tf32+bfloat16-dsp`` for a float32 cell
(convolutions and products in TF32; the transforms, float32 arithmetic that
TF32 does not touch, in bfloat16), ``fp8+tf32+bfloat16-dsp`` for a
bfloat16 cell (its bfloat16 convolutions in float8, what it keeps in
float32 in TF32), ``tf32`` for the codec-latent embed's gradient and
``bfloat16-dsp`` for a watermark without a codec.
"""

from __future__ import annotations

import dataclasses

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value (ties away from zero), as float32."""
    bits = x.float().contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with the tensor's largest magnitude scaled to 448."""
    amax = x.abs().amax().float().clamp(min=1e-30)
    scale = amax / 448.0
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _same(x: torch.Tensor) -> torch.Tensor:
    return x


@dataclasses.dataclass(frozen=True)
class Precision:
    name: str
    operand: object
    store: object
    wide: object
    dsp: object = _same


PRECISIONS = {
    "float32": Precision("float32", _same, _same, _same),
    "tf32": Precision("tf32", tf32, _same, tf32),
    "bfloat16": Precision("bfloat16", bf16, bf16, _same),
    "bfloat16-dsp": Precision("bfloat16-dsp", _same, _same, _same, bf16),
    "tf32+bfloat16-dsp": Precision("tf32+bfloat16-dsp", tf32, _same, tf32, bf16),
    "fp8+tf32+bfloat16-dsp": Precision("fp8+tf32+bfloat16-dsp", fp8, bf16, tf32, bf16),
}


def get(name: str) -> Precision:
    return PRECISIONS[name]


def no_tf32() -> None:
    """The reference's own rule: cuDNN and cuBLAS in true float32."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
