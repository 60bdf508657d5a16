"""PyTorch port of ``nawc_tpu`` for NVIDIA Hopper (H100).

The main path is the flagship graph of the JAX package: spread-spectrum
embed -> SNAC-style codec round-trip -> spread-spectrum detect, plus codec
encode to codes and the bucketed serving front door.  The module layout and
names follow ``nawc_tpu`` so that each counterpart is easy to find.

The package imports ``torch`` and ``numpy``, and ``scipy`` only where a
host metric (exact STOI, the PESQ proxy) resamples.  Entry points take
``device=`` (default ``"cuda"``) and raise if no GPU is present and the
caller did not ask for the CPU.  The three TPU kernels of the JAX package are
hand-written CUDA kernels here (``csrc/``), built with ``nvcc`` on first use
and bound with ``ctypes`` (``ops/_lib.py``); on CPU tensors every op runs its
plain PyTorch version.
"""

from .utils.device import resolve_device

__all__ = ["resolve_device"]
