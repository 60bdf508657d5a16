"""A run with its timed path broken underneath comes out not correct: for
each fault a cell can have (``port_bench/faults.py``), and for the control
(the reference in the precision below the configuration's, in the
program's place), at the test size on the CPU.  The harness's look for a
card is skipped; the rest of a run is driven as on the card."""

import pytest

from port_bench import faults

CASES = [
    ("roundtrip-f32", "flip_strongest_bit"),
    ("roundtrip-f32", "half_batch_roundtrip"),
    ("roundtrip-f32", "altered_code"),
    ("roundtrip-bf16", "flip_strongest_bit"),
    ("roundtrip-bf16", "half_batch_roundtrip"),
    ("roundtrip-bf16", "altered_code"),
    ("latent-embed-f32", "adam_unchanged"),
    ("latent-embed-f32", "half_batch_loss"),
    ("latent-embed-f32", "altered_output"),
]


@pytest.mark.parametrize("workload,fault", CASES, ids=[f"{w}-{f}" for w, f in CASES])
def test_fault_is_not_correct(small, workload, fault):
    with faults.planted(fault):
        line = small(workload)
    assert not line["correct"], line["checks"]


@pytest.mark.parametrize("workload", ["roundtrip-f32", "roundtrip-bf16", "latent-embed-f32"])
def test_control_is_not_correct(small, workload):
    line = small(workload, mode="control")
    assert not line["correct"], line["checks"]
