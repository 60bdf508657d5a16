"""One rank of ``tests/test_torch_parallel.py``'s gloo group, on the CPU:

    python tests/_torch_parallel_ranks.py <rank> <world> <dir>

It joins the group through a FileStore in <dir>, reads ``inputs.npz``,
``cfg.json`` (the codec config) and ``tiny.msgpack`` (its weights) there,
runs the port's parallel paths and writes ``rank<rank>.pt``.  It imports
torch and the port only."""

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from nawc_tpu_torch.codec import codec_from_flax  # noqa: E402
from nawc_tpu_torch.codec.convert import state_dict_to_flax  # noqa: E402
from nawc_tpu_torch.entry import flagship  # noqa: E402
from nawc_tpu_torch.parallel import make_mesh, make_sharded_eval, shard_batch, tp_nearest_codebook  # noqa: E402
from nawc_tpu_torch.train import codec_train  # noqa: E402
from nawc_tpu_torch.utils.checkpoint import load_params, tree_leaves  # noqa: E402
from nawc_tpu_torch.utils.config import CodecConfig  # noqa: E402


def main(rank: int, world: int, d: Path) -> None:
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"file://{d / 'store'}", rank=rank, world_size=world)
    try:
        x = {k: torch.from_numpy(v) for k, v in np.load(d / "inputs.npz").items()}
        cfg_kw = json.loads((d / "cfg.json").read_text())
        cfg = CodecConfig(**{k: tuple(v) if isinstance(v, list) else v for k, v in cfg_kw.items()})
        tree = load_params(d / "tiny.msgpack")
        dp = make_mesh(n_data=world, n_model=1, device="cpu")
        tp = make_mesh(n_data=1, n_model=world, device="cpu")
        out = {"shapes": [make_mesh(device="cpu").shape, dp.shape, tp.shape]}

        out["tp_codes"] = tp_nearest_codebook(x["z"], x["codebook"], tp)
        out["batch_shard"] = shard_batch(torch.arange(64.0).reshape(16, 4), dp)

        codec, wm = flagship(codec_from_flax(tree, cfg, device="cpu"), "cpu")
        run = make_sharded_eval(codec, wm, dp)
        shards = run(x["wav"], x["msg"])
        out["eval_shard_rows"] = shards[0].shape[0]
        out["eval"] = run.gather(*shards)

        # PyTorch's native CPU convolutions, as the single-device trainer
        # tests run them (oneDNN's float32 conv backward is less accurate);
        # two steps of the warmup-cosine AdamW (the first at learning rate
        # 0), with the mesh and, on rank 0, without it on the whole batch
        with torch.backends.mkldnn.flags(enabled=False):
            for label, mesh in [("dp", dp)] + [("single", None)] * (rank == 0):
                model = codec_train.trainable_codec(cfg, device="cpu", tree=tree)
                state = codec_train.CodecTrainState(
                    model, codec_train.make_optimizer(model.parameters(), 1e-3, total=10), 0)
                step = codec_train.make_codec_train_step(cfg, mesh=mesh)
                out[label] = []
                for w in (x["w1"], x["w2"]):
                    metrics = step(state, w)
                    params = {k: torch.from_numpy(np.array(v)) for k, v in
                              tree_leaves(state_dict_to_flax(state.model)["params"]).items()}
                    out[label].append((metrics, params))
        torch.save(out, d / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), Path(sys.argv[3]))
