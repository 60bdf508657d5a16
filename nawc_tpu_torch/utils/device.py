"""Device selection for the port's entry points.

Entry points default to the GPU.  Without one they raise instead of falling
back to the CPU quietly: a run that was meant for the card must not report
CPU numbers.  Tests pass ``device="cpu"`` explicitly.
"""

from __future__ import annotations

import contextlib

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """-> a ``torch.device``; raises if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    return dev


def float32_parity() -> None:
    """Turn TF32 off for cuDNN and cuBLAS, for the whole process (the CLIs
    do): they default to TF32, which breaks float32 parity with the JAX
    reference."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


@contextlib.contextmanager
def no_tf32():
    """TF32 off for cuDNN and cuBLAS inside the block; the flags are
    restored as they were on the way out, an exception included."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    float32_parity()
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved
