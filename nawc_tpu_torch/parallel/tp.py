"""Tensor-parallel RVQ codebook lookup over the "model" mesh dim
(``nawc_tpu/parallel/tp.py``).

The (K, D) codebook is split row-wise over "model"; each process looks its
queries up in its K/n rows (the CUDA lookup kernel on the card), and the
global winner comes from the (score, index) pairs of all shards: one
all_gather of two numbers per query.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops import nearest_codebook
from ..ops.rvq import _l2_normalize
from .mesh import Mesh


def shard_best(z: torch.Tensor, shard: torch.Tensor, offset: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, D) queries x a (K/n, D) shard -> (score (N,), global index (N,))
    of each query's best row in the shard.  The lookup returns codes only,
    so the winner's cosine is recomputed in the plain form."""
    idx = nearest_codebook(z, shard).long()
    score = (_l2_normalize(z) * _l2_normalize(shard[idx])).sum(dim=-1)
    return score, idx + offset


def combine_shards(scores: torch.Tensor, idxs: torch.Tensor) -> torch.Tensor:
    """(n_shards, N) scores and global indices, shards in rank order ->
    (N,) int32 codes: the first maximum over shards, as ``argmax`` takes it
    over the whole codebook."""
    win = torch.argmax(scores, dim=0)
    return idxs.gather(0, win[None])[0].to(torch.int32)


def tp_nearest_codebook(z: torch.Tensor, codebook: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """(N, D) queries x (K, D) codebook -> (N,) int32 codes, with the
    codebook split over the mesh's "model" dim.  Every process of a "model"
    group passes the same `z` (its "data" shard, see ``shard_batch``) and
    the whole codebook, of which it reads its own rows."""
    z = z.detach()
    shard = mesh.shard(codebook.detach(), "model")
    score, idx = shard_best(z, shard, mesh.coordinate("model") * shard.shape[0])
    # float64 holds a float32 score and an index below 2^53 exactly
    pair = torch.stack([score.double(), idx.double()])
    parts = [torch.empty_like(pair) for _ in range(mesh.shape["model"])]
    dist.all_gather(parts, pair, group=mesh.group("model"))
    gathered = torch.stack(parts, dim=1)  # (2, n_model, N)
    return combine_shards(gathered[0], gathered[1].long())
