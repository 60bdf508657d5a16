"""The port's mel filterbank and log-mel spectrogram
(``nawc_tpu_torch/dsp/mel.py``) against nawc_tpu's on the CPU: the
filterbank equal, the mel scale within 1e-12, the log-mel within 1e-5, at
the trainers' three scales and at eval_codec's; and the ``--cfg.<field>``
flags (``utils/flags.py``) that ``train_codec`` builds its config with."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from _torch_port import t
from nawc_tpu.dsp import mel as jmel
from nawc_tpu.utils.config import MelConfig as JaxMel
from nawc_tpu.utils.config import StftConfig as JaxStft
from nawc_tpu_torch.dsp import mel
from nawc_tpu_torch.utils.config import MelConfig, StftConfig


def test_mel_scale_matches():
    f = np.array([0.0, 10.0, 440.0, 999.9, 1000.0, 4000.0, 12_000.0])
    np.testing.assert_allclose(mel.hz_to_mel(f), jmel.hz_to_mel(f), rtol=0, atol=1e-12)
    m = np.linspace(0, 40, 17)
    np.testing.assert_allclose(mel.mel_to_hz(m), jmel.mel_to_hz(m), rtol=0, atol=1e-12)


@pytest.mark.parametrize("sr,n_fft,n_mels,fmin,fmax", [
    (24_000, 512, 40, 0.0, None), (24_000, 1024, 80, 0.0, None), (24_000, 2048, 120, 0.0, None),
    (16_000, 1024, 80, 0.0, None), (16_000, 512, 40, 60.0, 7000.0),
])
def test_filterbank_and_log_mel_match(sr, n_fft, n_mels, fmin, fmax):
    jc, tc = JaxMel(sr, n_fft, n_mels, fmin, fmax), MelConfig(sr, n_fft, n_mels, fmin, fmax)
    np.testing.assert_array_equal(mel.mel_matrix(tc).numpy(), np.asarray(jmel.mel_matrix(jc)))
    x = (np.random.default_rng(n_fft).normal(size=(2, 9000)) * 0.1).astype(np.float32)
    for log in (True, False):
        want = np.asarray(jmel.mel_spectrogram(jnp.asarray(x), JaxStft(n_fft, n_fft // 4, n_fft), jc, log=log))
        got = mel.mel_spectrogram(t(x), StftConfig(n_fft, n_fft // 4, n_fft), tc, log=log).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5 if not log else 0)


def test_flags_build_the_codec_config_as_jax():
    """``--cfg.<field>`` overrides (``utils/flags.py``) give the JAX
    package's CodecConfig fields, tuples and all."""
    import argparse

    from nawc_tpu.utils import flags as jflags
    from nawc_tpu.utils.config import CodecConfig as JaxCodec
    from nawc_tpu_torch.utils import flags
    from nawc_tpu_torch.utils.config import CodecConfig

    argv = ["--cfg.encoder_dim", "16", "--cfg.vq_strides", "8,4,2,1", "--cfg.noise_decoder", "false",
            "--cfg.compute_dtype", "bfloat16"]
    for mod, cls in ((jflags, JaxCodec), (flags, CodecConfig)):
        ap = argparse.ArgumentParser()
        mod.add_dataclass_args(ap, cls, "cfg")
        cfg = mod.dataclass_from_args(cls, ap.parse_args(argv), "cfg")
        assert dataclasses.asdict(cfg) == {**dataclasses.asdict(cls()), "encoder_dim": 16,
                                           "vq_strides": (8, 4, 2, 1), "noise_decoder": False,
                                           "compute_dtype": "bfloat16"}
        base = cls(latent_dim=64)
        assert mod.dataclass_from_args(cls, ap.parse_args([]), "cfg", base=base) is base
