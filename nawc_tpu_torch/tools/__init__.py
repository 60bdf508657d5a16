"""Measurement tools that run on the card, from the root of a checkout:

    python3 -m nawc_tpu_torch.tools.conv_layers [--codec codec24k|snac44k] [--dtype bfloat16]
    python3 -m nawc_tpu_torch.tools.snake_times [--other DIR]

Each exits 1 without a CUDA device; importing them starts nothing.
"""
