"""The port's ``parallel/`` over ``torch.distributed`` against nawc_tpu's on
the CPU: two gloo processes (``tests/_torch_parallel_ranks.py``, spawned
once for the module, joined by a FileStore) run the mesh helpers, the
tensor-parallel lookup over a 1 x 2 mesh, and the sharded evaluation and
the data-parallel codec step over a 2 x 1 mesh; the tests hold their
results to JAX's with the bars of ``tests/test_parallel.py``."""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from _torch_port import TINY, speech, tiny_codecs
from nawc_tpu.attacks.codec import codec_roundtrip as jax_codec_roundtrip
from nawc_tpu.models import SpreadSpectrumWM as JaxWM
from nawc_tpu.ops import nearest_codebook_reference as jax_lookup
from nawc_tpu.train import codec_train as jct
from nawc_tpu.utils.checkpoint import save_params as jax_save_params
from nawc_tpu.utils.config import CodecConfig as JaxCodecCfg
from nawc_tpu.utils.config import SpreadSpectrumConfig as JaxSSCfg
from nawc_tpu_torch.parallel import combine_shards, data_sharding, make_mesh, replicate_sharding
from nawc_tpu_torch.utils.checkpoint import tree_leaves

WORLD = 2
T_CODEC = 8192
UPDATE_TOL = 1e-4  # the trainer tests' excused-sample rule: entries off by more than this ...
EXCUSED = 1e-3     # ... must stay under this share
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    d = tmp_path_factory.mktemp("gloo")
    jax_save_params(d / "tiny.msgpack", tiny_codecs()[0].params)
    (d / "cfg.json").write_text(json.dumps(TINY))
    rng = np.random.default_rng(0)
    x = {"z": rng.normal(size=(64, 8)).astype(np.float32),
         "codebook": rng.normal(size=(128, 8)).astype(np.float32),
         "wav": (rng.normal(size=(4, 2 * T_CODEC)) * 0.1).astype(np.float32),
         "msg": rng.integers(0, 2, (4, 16)).astype(np.int32),
         "w1": speech(24_000, 4, T_CODEC / 24_000, seed=5),
         "w2": speech(24_000, 4, T_CODEC / 24_000, seed=6)}
    np.savez(d / "inputs.npz", **x)
    script = Path(__file__).with_name("_torch_parallel_ranks.py")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(WORLD), str(d)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    return x, [torch.load(d / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


def test_mesh_shapes(ranks):
    _, out = ranks
    for r in out:
        assert r["shapes"] == [{"data": 2, "model": 1}, {"data": 2, "model": 1},
                               {"data": 1, "model": 2}]


def test_shard_batch_gives_each_rank_its_rows(ranks):
    _, out = ranks
    whole = torch.arange(64.0).reshape(16, 4)
    assert torch.equal(torch.cat([r["batch_shard"] for r in out]), whole)
    assert out[1]["batch_shard"].shape == (8, 4)


def test_sharding_helpers():
    assert data_sharding(None, 3) == (Shard(0), Replicate())
    assert replicate_sharding(None) == (Replicate(), Replicate())


def test_make_mesh_needs_a_process_group():
    with pytest.raises(RuntimeError, match="process group"):
        make_mesh(device="cpu")


def test_tp_lookup_matches_reference(ranks):
    x, out = ranks
    want = np.asarray(jax_lookup(jnp.asarray(x["z"]), jnp.asarray(x["codebook"])))
    for r in out:
        np.testing.assert_array_equal(r["tp_codes"].numpy(), want)


def test_combine_takes_the_first_maximum_in_rank_order():
    scores = torch.tensor([[0.5, 0.9, 0.7], [0.5, 0.9, 0.8]])
    idxs = torch.tensor([[3, 1, 2], [70, 65, 66]])
    assert combine_shards(scores, idxs).tolist() == [3, 1, 66]


def test_sharded_eval_matches_unsharded_jax(ranks):
    x, out = ranks
    jc, _ = tiny_codecs()
    wm = JaxWM(cfg=JaxSSCfg(sample_rate=24_000, band_hi_hz=9000.0, alpha=0.1))
    marked = wm.embed(jnp.asarray(x["wav"]), jnp.asarray(x["msg"]))
    attacked = jax_codec_roundtrip(jc, marked, in_sr=24_000)
    presence, bits = wm.detect(attacked)
    for r in out:
        assert r["eval_shard_rows"] == 2
        m, a, p, b = (v.numpy() for v in r["eval"])
        np.testing.assert_allclose(m, np.asarray(marked), atol=1e-5)
        np.testing.assert_allclose(a, np.asarray(attacked), atol=1e-4)
        np.testing.assert_allclose(p, np.asarray(presence), atol=1e-4)
        np.testing.assert_array_equal(b, np.asarray(bits))


def _leaves(params) -> dict:
    return {k: np.asarray(v) for k, v in tree_leaves(jax.tree_util.tree_map(np.asarray, params)).items()}


def test_dp_train_step_matches_single_device(ranks):
    """Two data-parallel steps (the first at learning rate 0) against JAX's
    single-device steps: after the first every parameter within 2e-4 (JAX's
    bar); after the second, JAX's sign-like first Adam update off by more
    than 1e-4 in under 0.1% of the entries, as the port's single-device step
    (ROADMAP.md C).  Against the port's own single-device step on the whole
    batch, every parameter within 2e-4 after both; every float metric within
    1e-5 relative of JAX's, the usage histograms equal; the two ranks' replicas
    equal."""
    x, out = ranks
    tx = jct.make_optimizer(1e-3, total=10)
    params = tiny_codecs()[0].params
    opt_state = tx.init(params)
    jstep = jct.make_codec_train_step(JaxCodecCfg(**TINY), tx)
    for i, w in enumerate(("w1", "w2")):
        params, opt_state, jm = jstep(params, opt_state, jnp.asarray(x[w]))
        metrics, got = out[0]["dp"][i]
        want = _leaves(params["params"])
        single = out[0]["single"][i][1]
        for k in want:
            assert torch.equal(got[k], out[1]["dp"][i][1][k]), k
            np.testing.assert_allclose(got[k].numpy(), single[k].numpy(), rtol=0, atol=2e-4, err_msg=k)
        diff = np.concatenate([np.abs(got[k].numpy() - want[k]).ravel() for k in want])
        if i == 0:
            assert diff.max() <= 2e-4, diff.max()
        assert (diff > UPDATE_TOL).sum() < EXCUSED * diff.size, ((diff > UPDATE_TOL).sum(), diff.size)
        assert set(metrics) == set(jm)
        for k, v in jm.items():
            if k.startswith("usage_"):
                np.testing.assert_array_equal(metrics[k].numpy(), np.asarray(v))
            else:
                assert abs(float(metrics[k]) - float(v)) <= LOSS_RTOL * abs(float(v)), (k, metrics[k], v)
