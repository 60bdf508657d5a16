"""The plain reference that decides ``correct``: the SNAC-style codec, the
spread-spectrum watermark and the codec-latent embed's loss and Adam step,
written from their definitions in plain PyTorch and numpy.

Nothing here imports the measured package or the JAX one.  The weights
are the state dict the benchmark drew (``port_bench/weights.py``), keyed
by parameter name; every table the program derives from them or from its
settings (the PN patterns, the PCA axis, padded batches) is worked out
again here.  Convolutions and products run in float32 with TF32 off; a
lower precision is emulated by rounding operands (``precision.py``), so
that the control runs alike on the card and on the CPU.
"""
