"""nawc_tpu_torch utils against nawc_tpu: configs, padding, the msgpack
checkpoint reader and the numpy threefry generator."""

import dataclasses
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax import serialization

import _torch_port  # noqa: F401  (caps torch threads)
from _torch_port import t
from nawc_tpu.codec import SnacCodec
from nawc_tpu.utils import config as jcfg
from nawc_tpu.utils.checkpoint import load_params
from nawc_tpu.utils import padding as jpad
from nawc_tpu_torch.utils import checkpoint, jaxrand, padding
from nawc_tpu_torch.utils import config as tcfg

CKPT = Path(__file__).resolve().parent.parent / "checkpoints" / "codec_24k.msgpack"


PORT_ONLY = {"CodecConfig": [("layout", "nawc"), ("depthwise", False), ("attn_window", 0),
                             ("noise_blocks", False)]}


@pytest.mark.parametrize("name", ["StftConfig", "CodecConfig", "SpreadSpectrumConfig",
                                  "SemanticWMConfig", "MelConfig", "NeuralWMConfig"])
def test_config_fields_and_defaults(name):
    jc, tc = getattr(jcfg, name)(), getattr(tcfg, name)()
    jf = [(f.name, f.default) for f in dataclasses.fields(jc)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tc)]
    # the port's own keys (SNAC's layout; the JAX package has none) follow JAX's, off by default
    own = PORT_ONLY.get(name, [])
    assert jf == tf[: len(tf) - len(own)] and tf[len(tf) - len(own):] == own
    for prop in ("n_bins", "hop", "chunk", "num_levels"):
        if hasattr(jc, prop):
            assert getattr(jc, prop) == getattr(tc, prop)


def test_codec_chunk_is_4096():
    assert tcfg.CodecConfig().chunk == 4096


@pytest.mark.parametrize("n,target", [(10, 16), (16, 16), (20, 7)])
def test_padding_matches(n, target):
    x = np.arange(2 * n, dtype=np.float32).reshape(2, n)
    np.testing.assert_array_equal(
        padding.pad_axis_to(t(x), target).numpy(), np.asarray(jpad.pad_axis_to(jnp.asarray(x), target)))
    np.testing.assert_array_equal(
        padding.pad_to_multiple(t(x), 8).numpy(), np.asarray(jpad.pad_to_multiple(jnp.asarray(x), 8)))
    np.testing.assert_array_equal(
        padding.fix_length(t(x), target, axis=1).numpy(),
        np.asarray(jpad.fix_length(jnp.asarray(x), target, axis=1)))
    for buckets in [(8, 16), (4,)]:
        assert padding.bucket_length(n, buckets) == jpad.bucket_length(n, buckets)


def test_checkpoint_reader_matches_flax():
    """Every leaf of codec_24k.msgpack equals what nawc_tpu's flax
    ``load_params`` restores (into the codec's init structure)."""
    template = jax.eval_shape(SnacCodec(jcfg.CodecConfig()).init, jax.random.PRNGKey(0),
                              jnp.zeros((1, 4096), jnp.float32))
    ref = jax.tree_util.tree_flatten_with_path(load_params(CKPT, template))[0]
    ref = {"/".join(k.key for k in path): leaf for path, leaf in ref}
    ours = checkpoint.tree_leaves(checkpoint.load_params(CKPT))
    assert len(ours) == 193
    assert ours.keys() == ref.keys()
    for k in ref:
        assert ours[k].dtype == ref[k].dtype and ours[k].shape == ref[k].shape, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_checkpoint_reader_types():
    """Every msgpack family flax may write: nested maps, ints of each width,
    floats, bool/nil, str and arrays, int/float/bool ndarrays and scalars."""
    tree = {
        "a": {"w": np.arange(6, dtype=np.int64).reshape(2, 3),
              "b": np.array([True, False]), "h": np.float16(1.5)},
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, -1, -33, -129, -40000, -2**40],
        "f": 0.25, "none": None, "yes": True, "s": "x" * 40, "long": "y" * 300,
        "e": np.zeros((0, 4), np.float32), "big": np.ones(70_000, np.float32),
    }
    data = serialization.msgpack_serialize(tree)
    got = checkpoint.unpackb(data)
    want = serialization.msgpack_restore(data)
    flat_g, flat_w = checkpoint.tree_leaves(got), checkpoint.tree_leaves(want)
    assert flat_g.keys() == flat_w.keys()
    for k, v in flat_w.items():
        if isinstance(v, np.ndarray):
            assert flat_g[k].dtype == v.dtype
            np.testing.assert_array_equal(flat_g[k], v)
        else:
            assert flat_g[k] == v and type(flat_g[k]) is type(v), k


def test_checkpoint_reader_rejects_truncation():
    data = serialization.msgpack_serialize({"w": np.ones(8, np.float32)})
    with pytest.raises(ValueError):
        checkpoint.unpackb(data[:-3])


@pytest.mark.parametrize("seed", [0, 1, 7, 2**32 + 3])
def test_prng_key_and_fold_in(seed):
    k = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(jaxrand.prng_key(seed), np.asarray(k))
    for b in (0, 1, 59, 2**31 + 5):
        np.testing.assert_array_equal(
            jaxrand.fold_in(jaxrand.prng_key(seed), b), np.asarray(jax.random.fold_in(k, b)))


@pytest.mark.parametrize("shape", [(16, 92), (3, 5, 7), (1,), (1001,)])
def test_bernoulli_and_uniform_bits(shape):
    key = jax.random.fold_in(jax.random.PRNGKey(7), 3)
    ours = jaxrand.fold_in(jaxrand.prng_key(7), 3)
    np.testing.assert_array_equal(jaxrand.uniform(ours, shape), np.asarray(jax.random.uniform(key, shape)))
    for p in (0.5, 0.1):
        np.testing.assert_array_equal(
            jaxrand.bernoulli(ours, p, shape), np.asarray(jax.random.bernoulli(key, p, shape)))


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("n_bits", [16, 60])
def test_pn_patterns_bit_identical(seed, n_bits):
    from nawc_tpu.models.spread_spectrum import _pn_patterns as jax_patterns
    from nawc_tpu_torch.models.spread_spectrum import _pn_patterns_np

    for sr, hi in [(16_000, 6000.0), (24_000, 9000.0)]:
        jc = jcfg.SpreadSpectrumConfig(sample_rate=sr, n_bits=n_bits, band_hi_hz=hi)
        tc = tcfg.SpreadSpectrumConfig(sample_rate=sr, n_bits=n_bits, band_hi_hz=hi)
        want = np.asarray(jax_patterns(jax.random.PRNGKey(seed), jc))
        np.testing.assert_array_equal(_pn_patterns_np(seed, tc), want)


@pytest.mark.parametrize("seed", [0, 5, 2**31 + 7])
def test_split_matches_jax(seed):
    k = jax.random.PRNGKey(seed)
    for num in (2, 3, 7):
        np.testing.assert_array_equal(jaxrand.split(jaxrand.prng_key(seed), num),
                                      np.asarray(jax.random.split(k, num)))


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (-1.0, 1.0), (-0.5, 0.5), (0.05, 0.9),
                                   (0.02, 0.15), (-10.0, 10.0)])
def test_uniform_range_bit_for_bit(lo, hi):
    """The ranges the attacks draw (time_jitter, vorbis, eq): bit for bit."""
    for seed, shape in [(5, (2, 126, 513)), (9, (5,)), (1, (3, 32))]:
        want = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape, minval=lo, maxval=hi))
        got = jaxrand.uniform(jaxrand.prng_key(seed), shape, lo, hi)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 5])
def test_normal_within_two_ulp(seed):
    """jax.random.normal is sqrt(2) erf_inv(u) with XLA's float32 log1p
    inside.  The replica's log differs from XLA's CPU log by 1 ulp in
    about 5 of 10^6 arguments, which reaches the draw as at most 2 ulp in
    about 1 draw in 10^6."""
    shape = (32, 32_000)
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    got = jaxrand.normal(jaxrand.prng_key(seed), shape)
    ulp = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert got.dtype == np.float32 and ulp.max() <= 2
    assert (ulp > 0).sum() <= 5


def test_erf_inv_and_log1p_match_xla():
    """XLA's float32 log1p (Cephes' rational function below |x| = 0.414,
    its log above) and erf_inv on the CPU: equal but for 1 ulp in a few
    arguments in 10^5."""
    x = -np.linspace(0.0, 0.99999, 400_001).astype(np.float32)
    for ours, theirs in [(jaxrand._log1p(x), jnp.log1p(jnp.asarray(x))),
                         (jaxrand.erf_inv(x), jax.lax.erf_inv(jnp.asarray(x)))]:
        ulp = np.abs(ours.view(np.int32).astype(np.int64)
                     - np.asarray(theirs).view(np.int32).astype(np.int64))
        assert ulp.max() <= 1 and (ulp > 0).mean() < 1e-4


@pytest.mark.parametrize("n", [1, 2, 3, 100, 128, 1000, 4096])
def test_permutation_and_choice_bit_for_bit(n):
    """jax's shuffle: one stable sort by threefry bits per round, rounds
    ceil(3 ln n / ln(2^32 - 1)) (1 up to n = 1625, 2 at 4096)."""
    for seed in (0, 42, 7):
        want = np.asarray(jax.random.permutation(jax.random.PRNGKey(seed), n))
        got = jaxrand.permutation(jaxrand.prng_key(seed), n)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
        k = min(n, 2)
        np.testing.assert_array_equal(
            jaxrand.choice(jaxrand.prng_key(seed), n, (k,)),
            np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,), replace=False)))
