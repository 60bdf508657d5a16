"""Sharded evaluation (``nawc_tpu/parallel/eval.py``): embed -> codec
round-trip attack -> detect, with the clip batch split over the mesh's
"data" dim.

The multi-device form of the reference's per-file survivability loop
(``watermark_testing.py:798-838``): each process takes its shard of the
clips with the codec and the watermarker replicated.  Every op is
batch-parallel, so the run needs no communication; :meth:`ShardedEval.gather`
puts the batch back together afterwards.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..attacks.codec import codec_roundtrip
from .mesh import Mesh, shard_batch


class ShardedEval:
    """``run(wav (B, T), msg (B, n_bits))`` -> this process's (marked,
    attacked, presence, bits) of its "data" shard of the batch; B must be a
    multiple of ``mesh.shape["data"]``."""

    def __init__(self, codec, wm, mesh: Mesh):
        self.codec, self.wm, self.mesh = codec, wm, mesh

    @torch.no_grad()
    def __call__(self, wav: torch.Tensor, msg: torch.Tensor):
        wav, msg = shard_batch((wav, msg), self.mesh)
        marked = self.wm.embed(wav, msg)
        attacked = codec_roundtrip(self.codec, marked, in_sr=self.wm.sample_rate)
        presence, bits = self.wm.detect(attacked)
        return marked, attacked, presence, bits

    def gather(self, *shards: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """Each process's shards, concatenated over "data" in rank order."""
        group, n = self.mesh.group("data"), self.mesh.shape["data"]
        out = []
        for x in shards:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=group)
            out.append(torch.cat(parts))
        return tuple(out)


def make_sharded_eval(codec, wm, mesh: Mesh) -> ShardedEval:
    return ShardedEval(codec, wm, mesh)
