"""Shared pieces of the tests that hold ``nawc_tpu_torch`` against
``nawc_tpu`` on the CPU: the tiny codec of ``tests/test_rvq_fused.py``, with
the same flax weights in both packages, the near-tie rule for codes,
speech-like clips and the excused-sample rule for detector gradients."""

from __future__ import annotations

import contextlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nawc_tpu.codec import SnacCodec
from nawc_tpu.codec.api import CodecState as JaxCodecState
from nawc_tpu.utils.config import CodecConfig as JaxCodecConfig
from nawc_tpu_torch.codec import codec_from_flax
from nawc_tpu_torch.ops.parity import near_tie_mismatches
from nawc_tpu_torch.ops.rvq import score_margin
from nawc_tpu_torch.utils.config import CodecConfig

# tier-1 runs six xdist workers; keep each one's torch to two threads
torch.set_num_threads(2)

TINY = dict(
    encoder_dim=8, encoder_rates=(2, 4, 8, 8), latent_dim=64,
    decoder_dim=64, decoder_rates=(8, 8, 4, 2),
    codebook_size=128, codebook_dim=8, vq_strides=(4, 2, 1),
)


def tiny_codecs(seed: int = 0):
    """-> (JAX CodecState, port CodecState) with identical random weights.

    The flax tree's shapes come from ``jax.eval_shape`` of the codec's init
    (no compile); every leaf is drawn from numpy, so that biases, Snake
    alphas and the decoder's output conv (all zero at flax init) are reached
    by the comparison too."""
    cfg = JaxCodecConfig(**TINY)
    shapes = jax.eval_shape(SnacCodec(cfg).init, jax.random.PRNGKey(seed),
                            jnp.zeros((1, 4096), jnp.float32))
    rng = np.random.default_rng(seed + 100)

    def draw(path, leaf):
        name = path[-1].key
        if name in ("bias", "log_alpha"):
            return (rng.normal(size=leaf.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1])) if name == "kernel" else leaf.shape[-1]
        # 0.8 of the LeCun scale keeps the latents near the trained codec's
        # range (max ~6 here, ~8 for codec_24k); at the full scale the
        # residual stacks grow them to ~100
        return (rng.normal(size=leaf.shape) * 0.8 / np.sqrt(fan_in)).astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(draw, jax.tree_util.tree_map(lambda x: x, shapes))
    tree = jax.tree_util.tree_map(np.asarray, tree)
    jc = JaxCodecState(cfg=cfg, params=jax.tree_util.tree_map(jnp.asarray, tree))
    return jc, codec_from_flax(tree, CodecConfig(**TINY), device="cpu")


def t(x) -> torch.Tensor:
    """numpy / jax array -> a CPU torch tensor (a copy)."""
    return torch.from_numpy(np.array(x))


def fma_once(a, b, c) -> np.ndarray:
    """float32 ``a * b + c`` rounded once: the product is exact in float64,
    the sum is rounded to odd in float64 (its exact error by TwoSum), then
    to nearest float32, which rounds the exact value once (Boldo and
    Melquiond: round-to-odd with 53 >= 24 + 2 bits; a subnormal float32
    result keeps fewer bits, so it holds there too)."""
    p = np.asarray(a, np.float64) * np.asarray(b, np.float64)
    c = np.asarray(c, np.float64)
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    even = (np.asarray(s).view(np.int64) & 1) == 0
    toward = np.nextafter(s, np.where(err > 0, np.inf, -np.inf))
    return np.where((err != 0) & even, toward, s).astype(np.float32)


def assert_codes_match(got, want, z_e=None, codebook=None) -> int:
    """Codes equal, except where the reference's top-2 cosine margin is
    below 1e-4 (needs the projected frames z_e and the codebook).
    -> the number of near-tie mismatches."""
    got, want = t(got), t(want)
    if z_e is None:
        assert got.shape == want.shape, (got.shape, want.shape)
        assert torch.equal(got, want), f"{int((got != want).sum())} codes differ"
        return 0
    return near_tie_mismatches(got, want, score_margin(t(z_e), t(codebook)))


def speech(sr: int, n: int, seconds: float, seed: int) -> np.ndarray:
    """(n, seconds * sr) speech-like clips: five harmonics of an f0 under a
    syllable-rate envelope, plus noise."""
    rng = np.random.default_rng(seed)
    tt = np.arange(int(sr * seconds)) / sr
    f0 = rng.uniform(110, 220, (n, 1))
    env = np.clip(np.sin(2 * np.pi * rng.uniform(3, 5, (n, 1)) * tt), 0, None) ** 2
    tone = sum(np.sin(2 * np.pi * h * f0 * tt) / h for h in range(1, 6)) * env
    return (0.2 * tone + 0.01 * rng.normal(size=(n, tt.size))).astype(np.float32)


def assert_gradient_close(got: np.ndarray, want: np.ndarray) -> None:
    """A detector gradient against JAX's: within 1e-4 of the largest
    |gradient| in all but 1% of the samples and within 1e-3 of it
    everywhere (the spread-spectrum score's gradient is ill-conditioned at
    quiet samples; ROADMAP.md C)."""
    scale = np.abs(want).max()
    assert scale > 0
    err = np.abs(got - want)
    assert err.max() <= 1e-3 * scale, (err.max(), scale)
    assert (err > 1e-4 * scale).mean() <= 0.01, (err > 1e-4 * scale).mean()


def write_cli_data(root: Path) -> Path:
    """Two wavs of 1.4 s and 1.1 s at 16 kHz and ``tiny.msgpack``, the tiny
    codec's weights as a flax checkpoint (read with ``--codec_size small``,
    whose config is the tiny one) under `root`."""
    from nawc_tpu.utils.checkpoint import save_params
    from nawc_tpu_torch.utils import audio_io

    rng = np.random.default_rng(0)
    for i, seconds in enumerate((1.4, 1.1)):
        tt = np.arange(int(16_000 * seconds)) / 16_000
        x = 0.3 * np.sin(2 * np.pi * (150 + 40 * i) * tt) * (0.6 + 0.4 * np.sin(2 * np.pi * 4 * tt))
        audio_io.write_wav(root / f"clip{i}.wav", x + 0.02 * rng.normal(size=tt.size), 16_000)
    save_params(root / "tiny.msgpack", tiny_codecs()[0].params)
    return root


@contextlib.contextmanager
def jax_tiny_codec():
    """JAX's CLIs get the tiny codec's CodecState from ``load_codec``: what
    ``load_codec(<tiny.msgpack>, "small")`` returns, without tracing flax's
    init of the codec (about 20 s on the CPU) only to replace every leaf."""
    from nawc_tpu.cli import common

    mp = pytest.MonkeyPatch()
    mp.setattr(common, "load_codec", lambda ckpt, size="full": tiny_codecs()[0])
    try:
        yield
    finally:
        mp.undo()


def cli_common(root: Path) -> list[str]:
    """The arguments every interpretability CLI takes, for the data of
    :func:`write_cli_data`."""
    return ["--audio_glob", str(root / "*.wav"), "--filecount", "2", "--seconds", "1.0",
            "--codec_size", "small", "--codec_ckpt", str(root / "tiny.msgpack")]


def run_both(port_main, jax_main, argv: list[str], out: Path) -> None:
    """The port's CLI on the CPU into ``out/port``, JAX's into ``out/jax``."""
    port_main(argv + ["--out_dir", str(out / "port"), "--device", "cpu"])
    jax_main(argv + ["--out_dir", str(out / "jax")])


def assert_csv_close(out: Path, name: str, tol: float, rel: float = 0.0,
                     cols: dict[str, tuple[float, float]] | None = None) -> None:
    """The port's CSV against JAX's: the same columns in the same order, the
    same strings and integers, floats within tol + rel * |value| (`cols`
    gives a column its own (tol, rel))."""
    import pandas as pd

    got = pd.read_csv(out / "port" / name)
    want = pd.read_csv(out / "jax" / name)
    assert list(got.columns) == list(want.columns), name
    assert got.shape == want.shape, name
    for col in want.columns:
        g, w = got[col].to_numpy(), want[col].to_numpy()
        if not pd.api.types.is_numeric_dtype(want[col]):
            assert (g == w).all(), (name, col)
        else:
            t_, r_ = (cols or {}).get(col, (tol, rel))
            err = np.abs(g.astype(np.float64) - w)
            assert (err <= t_ + r_ * np.abs(w)).all(), (name, col, err.max())


def _artists(fig) -> list[dict]:
    """What a figure draws, axes by axes: its texts (title, axis and tick
    labels, annotations, legend) and the data of its lines, rectangles
    (bars, histogram bins), scatter collections and images."""
    from matplotlib.patches import Rectangle

    out = []
    for ax in fig.axes:
        legend = ax.get_legend()
        rec = {
            "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
            "xticks": [x.get_text() for x in ax.get_xticklabels()],
            "yticks": [x.get_text() for x in ax.get_yticklabels()],
            "texts": [x.get_text() for x in ax.texts],
            "legend": [x.get_text() for x in legend.get_texts()] if legend else [],
            "lines": [np.asarray(ln.get_xydata(), np.float64) for ln in ax.get_lines()],
            "bars": [np.array([p.get_x(), p.get_y(), p.get_width(), p.get_height()])
                     for p in ax.patches if isinstance(p, Rectangle)],
            "points": [np.asarray(c._offsets3d if hasattr(c, "_offsets3d") else c.get_offsets(), np.float64)
                       for c in ax.collections],
            "images": [np.asarray(im.get_array(), np.float64) for im in ax.images],
        }
        if hasattr(ax, "get_zlabel"):
            rec["zlabel"] = ax.get_zlabel()
        out.append(rec)
    return out


@contextlib.contextmanager
def drawn(root: Path):
    """Every figure saved inside, as [(its path relative to `root`, its
    artists)], recorded by patching ``Figure.savefig`` (after the save)."""
    from matplotlib.figure import Figure

    records: list = []
    save = Figure.savefig

    def savefig(fig, fname, *a, **k):
        save(fig, fname, *a, **k)
        records.append((str(Path(fname).relative_to(root)), _artists(fig)))

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Figure, "savefig", savefig)
        yield records


def assert_same_figures(got: list, want: list, tol: float = 1e-6) -> None:
    """Two recordings of :func:`drawn`: the same files in the same order,
    equal texts, the drawn data within `tol`."""
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, g_axes), (_, w_axes) in zip(got, want):
        assert len(g_axes) == len(w_axes), name
        for g, w in zip(g_axes, w_axes):
            assert g.keys() == w.keys(), name
            for k, v in w.items():
                if k in ("lines", "bars", "points", "images"):
                    assert len(g[k]) == len(v), (name, k)
                    for a, b in zip(g[k], v):
                        np.testing.assert_allclose(a, b, rtol=0, atol=tol, err_msg=f"{name} {k}")
                else:
                    assert g[k] == v, (name, k, g[k], v)


def assert_same_pngs(out: Path) -> list[str]:
    """The port's CLI under ``out/port`` wrote the PNG set JAX's wrote under
    ``out/jax``, none empty -> their names."""
    sets = {s: sorted(str(p.relative_to(out / s)) for p in (out / s).rglob("*.png")) for s in ("port", "jax")}
    assert sets["port"] == sets["jax"], sets
    assert all((out / "port" / n).stat().st_size > 0 for n in sets["port"])
    return sets["port"]
