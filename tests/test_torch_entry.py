"""The port's main path against nawc_tpu's on the CPU, on the tiny codec:
the flagship entry, the codec attacks and the serving front door; and the
isolation check that the port and chip_smoke.py need nothing of JAX."""

import contextlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_port import TINY, t, tiny_codecs
from nawc_tpu.attacks.codec import ablation_masks as jax_ablation_masks
from nawc_tpu.attacks.codec import codec_roundtrip as jax_codec_roundtrip
from nawc_tpu.attacks.codec import layer_ablation as jax_layer_ablation
from nawc_tpu.models import SpreadSpectrumWM as JaxWM
from nawc_tpu.runtime import WatermarkService as JaxService
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch.attacks import ablation_masks, codec_roundtrip, layer_ablation
from nawc_tpu_torch.entry import entry, flagship
from nawc_tpu_torch.runtime import WatermarkService
from nawc_tpu_torch.utils.config import CodecConfig

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def codecs():
    return tiny_codecs(seed=1)


def _jax_flagship_wm():
    return JaxWM(cfg=JaxSSCfg(sample_rate=24_000, band_hi_hz=9000.0, alpha=0.1))


def test_entry_matches_jax(codecs):
    jc, tc = codecs
    jw = _jax_flagship_wm()
    fn, (wav, msg) = entry(codec=tc, device="cpu")
    assert wav.shape == (2, 24_000) and msg.shape == (2, 16)
    marked, presence, bits = fn(wav, msg)
    jm = jw.embed(jnp.asarray(wav.numpy()), jnp.asarray(msg.numpy()))
    attacked = jax_codec_roundtrip(jc, jm, in_sr=24_000)
    jp, jb = jw.detect(attacked)
    np.testing.assert_allclose(marked.numpy(), np.asarray(jm), atol=1e-5)
    np.testing.assert_allclose(presence.numpy(), np.asarray(jp), atol=1e-3)
    z = np.asarray(jw._correlate(attacked))
    sure = np.abs(z) > 1e-2
    np.testing.assert_array_equal(bits.numpy()[sure], np.asarray(jb)[sure])


def test_flagship_defaults():
    codec, wm = flagship(device="cpu", codec_cfg=CodecConfig(**TINY))
    assert wm.cfg.sample_rate == codec.cfg.sample_rate == 24_000
    assert wm.cfg.band_hi_hz == 9000.0 and wm.cfg.alpha == 0.1


@pytest.mark.parametrize("in_sr", [None, 16_000])
def test_codec_roundtrip_matches(codecs, in_sr):
    jc, tc = codecs
    wav = (np.random.default_rng(2).normal(size=(2, 7000)) * 0.2).astype(np.float32)
    want = np.asarray(jax_codec_roundtrip(jc, jnp.asarray(wav), in_sr=in_sr))
    got = codec_roundtrip(tc, t(wav), in_sr=in_sr).numpy()
    assert got.shape == want.shape == (2, 7000)
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_layer_ablation_matches(codecs):
    jc, tc = codecs
    wav = (np.random.default_rng(3).normal(size=(1, 5000)) * 0.2).astype(np.float32)
    jmasks, tmasks = jax_ablation_masks(3), ablation_masks(3, device="cpu")
    assert list(jmasks) == list(tmasks)
    for name in ("full_all", "drop_last_1", "keep_only_2"):
        np.testing.assert_array_equal(tmasks[name].numpy(), np.asarray(jmasks[name]))
        want = np.asarray(jax_layer_ablation(jc, jnp.asarray(wav), jmasks[name]))
        got = layer_ablation(tc, t(wav), tmasks[name]).numpy()
        np.testing.assert_allclose(got, want, atol=5e-4)


def test_ablation_masks_default_to_cuda_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ablation_masks(3)


def test_service_matches_jax():
    jw = _jax_flagship_wm()
    _, tw = flagship(device="cpu", codec=tiny_codecs(seed=1)[1])
    buckets = (24_000, 48_000)
    jsvc = JaxService(jw, buckets=buckets, max_batch=2)
    tsvc = WatermarkService(tw, buckets=buckets, max_batch=2, device="cpu")
    rng = np.random.default_rng(4)
    lens = [16_800, 24_000, 31_200, 48_000, 20_000]
    clips = [(rng.normal(size=n) * 0.1).astype(np.float32) for n in lens]
    msgs = rng.integers(0, 2, (len(clips), 16)).astype(np.int32)
    j_marked = jsvc.embed(clips, msgs)
    t_marked = tsvc.embed(clips, msgs)
    assert [len(m) for m in t_marked] == lens
    for a, b in zip(t_marked, j_marked):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    jp, jb = jsvc.detect(j_marked)
    tp, tb = tsvc.detect(t_marked)
    np.testing.assert_allclose(tp, jp, atol=1e-3)
    np.testing.assert_array_equal(tb, jb)
    assert (tb == msgs).mean() > 0.95


_ISOLATED = r"""
import importlib, pkgutil, sys
BLOCKED = {"jax", "jaxlib", "flax", "optax", "msgpack", "nawc_tpu", "pandas", "matplotlib"}
for name in list(sys.modules):
    if name.split(".")[0] in BLOCKED:
        del sys.modules[name]

class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"import of {name} refused")
        return None

sys.meta_path.insert(0, Refuse())
import nawc_tpu_torch
names = [m.name for m in pkgutil.walk_packages(nawc_tpu_torch.__path__, "nawc_tpu_torch.")]
for name in names:
    importlib.import_module(name)
# the codec-latent families, PGD, the neural watermark, the trainers, the
# interpretability layer and the CLIs that load them lazily are walked too
assert {"nawc_tpu_torch.models.semantic", "nawc_tpu_torch.models.token_green",
        "nawc_tpu_torch.models.resampled", "nawc_tpu_torch.attacks.pgd",
        "nawc_tpu_torch.cli.benchmark", "nawc_tpu_torch.cli.watermark",
        "nawc_tpu_torch.models.neural", "nawc_tpu_torch.dsp.mel", "nawc_tpu_torch.utils.flags",
        "nawc_tpu_torch.train.codec_train", "nawc_tpu_torch.train.wm_train",
        "nawc_tpu_torch.train.adversarial", "nawc_tpu_torch.train.optim",
        "nawc_tpu_torch.cli.train_wm", "nawc_tpu_torch.cli.train_codec",
        "nawc_tpu_torch.cli.train_gan", "nawc_tpu_torch.cli.eval_codec",
        "nawc_tpu_torch.cli.__main__", "nawc_tpu_torch.interp.probe",
        "nawc_tpu_torch.interp.spectral", "nawc_tpu_torch.interp.saliency",
        "nawc_tpu_torch.interp.uncertainty", "nawc_tpu_torch.interp.ablation",
        "nawc_tpu_torch.interp.manifold", "nawc_tpu_torch.interp.latent_pca",
        "nawc_tpu_torch.cli.probe", "nawc_tpu_torch.cli.perturbation",
        "nawc_tpu_torch.cli.uncertainty", "nawc_tpu_torch.cli.ablation",
        "nawc_tpu_torch.cli.manifold", "nawc_tpu_torch.cli.pgd",
        "nawc_tpu_torch.cli.stats", "nawc_tpu_torch.eval.stoi_exact",
        "nawc_tpu_torch.eval.pesq_proxy", "nawc_tpu_torch.eval.quality",
        "nawc_tpu_torch.eval.reporting", "nawc_tpu_torch.cli.quality",
        "nawc_tpu_torch.cli.sample_data", "nawc_tpu_torch.parallel.mesh",
        "nawc_tpu_torch.parallel.tp", "nawc_tpu_torch.parallel.eval",
        "nawc_tpu_torch.utils.profiling", "nawc_tpu_torch.eval.figures",
        "nawc_tpu_torch.ops.jaxrand"} <= set(names)
from nawc_tpu_torch.eval import figures
assert not figures.available()
import chip_smoke
assert callable(chip_smoke.codec_latent) and callable(chip_smoke.pgd_phase)
assert callable(chip_smoke.neural_phase) and callable(chip_smoke.training_phase)
assert callable(chip_smoke.interp_phase) and callable(chip_smoke.quality_parallel_phase)
from nawc_tpu_torch.codec import make_codec
from nawc_tpu_torch.entry import entry
from nawc_tpu_torch.utils.config import CodecConfig
fn, args = entry(codec=make_codec(CodecConfig(**%r), device="cpu"), device="cpu")
marked, presence, bits = fn(*args)
assert marked.shape == (2, 24000) and presence.shape == (2,) and bits.shape == (2, 16)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not leaked, leaked
# scipy is imported only where a host metric resamples
assert "scipy" not in sys.modules
print("isolated OK", len(names))
""" % (TINY,)


def test_entry_leaves_the_tf32_flags_as_it_found_them(codecs, monkeypatch):
    """The entry turns TF32 off inside each call only: the caller's flags
    (here both on) hold before and after it, also when the call raises."""
    import nawc_tpu_torch.entry as entry_module

    inside = []
    roundtrip = entry_module.codec_roundtrip

    def recorded(codec, marked, in_sr=None):
        inside.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
        if len(inside) == 2:
            raise ValueError("a failing call")
        return roundtrip(codec, marked, in_sr=in_sr)

    monkeypatch.setattr(entry_module, "codec_roundtrip", recorded)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    fn, (wav, msg) = entry(codec=codecs[1], device="cpu")
    flags = []
    for _ in range(2):
        with contextlib.suppress(ValueError):
            fn(wav, msg)
        flags.append((torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32))
    assert inside == [(False, False)] * 2
    assert flags == [(True, True)] * 2


def test_port_and_chip_smoke_import_nothing_of_jax():
    proc = subprocess.run([sys.executable, "-c", _ISOLATED], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "isolated OK" in proc.stdout


def test_chip_smoke_fails_without_a_card():
    """Without CUDA the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
