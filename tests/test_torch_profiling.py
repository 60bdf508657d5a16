"""The port's profiling helpers (``utils/profiling.py``: the trace file,
the stage timer's summary, ``device_sync``) and the public names that
complete the port's API, against nawc_tpu's on the CPU."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_port  # noqa: F401  (caps torch threads)
import nawc_tpu.models as jax_models
import nawc_tpu.utils as jax_utils
from nawc_tpu.models.neural import decode_bits as jax_decode_bits
from nawc_tpu.utils import padding as jpad
from nawc_tpu.utils import profiling as jax_profiling
from nawc_tpu_torch.models import neural
from nawc_tpu_torch.utils import padding, profiling


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    with profiling.trace(tmp_path / "trace"):
        with profiling.annotate("quality_stage"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    data = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "quality_stage" in names and any("mm" in str(n) for n in names)


def test_stage_timer_summary_is_jaxs():
    got, want = profiling.StageTimer(), jax_profiling.StageTimer()
    for timer in (got, want):
        for name, n in (("embed", 2), ("detect", 1)):
            for _ in range(n):
                with timer.stage(name) as box:
                    box["result"] = torch.ones(3) if timer is got else jnp.ones(3)
        timer.totals.update({"embed": 0.5, "detect": 1.25})
    assert got.summary() == want.summary()
    assert got.summary().splitlines()[0].startswith("detect")


def test_device_sync_sums_every_leaf_in_float32():
    tree = {"a": torch.arange(4, dtype=torch.int32), "b": [torch.full((2, 2), 0.5), (torch.ones(3),)]}
    want = jax_profiling.device_sync({"a": jnp.arange(4, dtype=jnp.int32),
                                      "b": [jnp.full((2, 2), 0.5), (jnp.ones(3),)]})
    got = profiling.device_sync(tree)
    assert isinstance(got, float) and got == want == 11.0
    assert profiling.device_sync([]) == 0.0


@pytest.mark.parametrize("lengths,max_len", [([3, 0, 7], 7), ([5, 2], 9)])
def test_length_mask_matches(lengths, max_len):
    got = padding.length_mask(torch.tensor(lengths), max_len)
    want = jpad.length_mask(jnp.asarray(lengths), max_len)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("shape", [(50,), (2, 50), (50, 2), (3, 4), (9, 20)])
def test_ensure_mono_np_matches(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    np.testing.assert_array_equal(padding.ensure_mono_np(x), jpad.ensure_mono_np(x))


def test_ensure_mono_np_rejects_3d():
    with pytest.raises(ValueError, match="unsupported"):
        padding.ensure_mono_np(np.zeros((2, 2, 2)))


def test_decode_bits_matches():
    logits = np.random.default_rng(1).normal(size=(3, 40, 2 + 16)).astype(np.float32)
    got = neural.decode_bits(torch.from_numpy(logits))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_decode_bits(jnp.asarray(logits))))


def test_package_exports_cover_jaxs():
    import nawc_tpu.eval as jax_eval
    import nawc_tpu.parallel as jax_parallel
    import nawc_tpu_torch.eval as port_eval
    import nawc_tpu_torch.models as port_models
    import nawc_tpu_torch.parallel as port_parallel
    import nawc_tpu_torch.utils as port_utils

    for jax_mod, port_mod in ((jax_models, port_models), (jax_utils, port_utils), (jax_eval, port_eval),
                              (jax_parallel, port_parallel)):
        assert set(jax_mod.__all__) <= set(port_mod.__all__), set(jax_mod.__all__) - set(port_mod.__all__)
        assert all(hasattr(port_mod, n) for n in port_mod.__all__)
