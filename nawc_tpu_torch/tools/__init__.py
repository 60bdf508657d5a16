"""Measurement tools that run on the card, from the root of a checkout:

    python3 -m nawc_tpu_torch.tools.jaxrand_times [--other DIR]
    python3 -m nawc_tpu_torch.tools.profiler_windows [--seconds 150]

Each exits 1 without a CUDA device; importing them starts nothing.
"""
