"""The ("data", "model") device mesh over ``torch.distributed``
(``nawc_tpu/parallel/mesh.py``).

One process per device: clips (the batch) are split over "data" with the
model replicated, and the RVQ codebook may be split row-wise over "model"
(``parallel/tp.py``).  The caller starts the process group
(``torch.distributed.init_process_group``: NCCL for CUDA devices, gloo for
the CPU); :func:`make_mesh` joins it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

from ..utils.device import resolve_device

DIMS = ("data", "model")
_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


class Mesh:
    """A ("data", "model") :class:`DeviceMesh` with this process's device,
    ``shape`` as {dim: size}, and the "model" shards of the tensors split
    over it (kept per tensor, so that a kernel's table derived from a shard
    is made once while the tensor is unchanged)."""

    def __init__(self, device_mesh: DeviceMesh, device: torch.device):
        self.device_mesh = device_mesh
        self.device = device
        self.shape = dict(zip(DIMS, device_mesh.shape))
        self._shards: dict[tuple, tuple] = {}

    def group(self, dim: str) -> dist.ProcessGroup:
        return self.device_mesh.get_group(dim)

    def coordinate(self, dim: str) -> int:
        """This process's index along `dim`."""
        return self.device_mesh.get_local_rank(dim)

    def shard(self, x: torch.Tensor, dim: str) -> torch.Tensor:
        """This process's row block of `x` (a view) when `x`'s rows are
        split evenly over `dim`."""
        n = self.shape[dim]
        if x.shape[0] % n:
            raise ValueError(f"{x.shape[0]} rows do not split evenly over {n} {dim!r} ranks")
        state = (x._version, tuple(x.shape))
        hit = self._shards.get((x.data_ptr(), dim))
        if hit is None or hit[0] != state:
            rows = x.shape[0] // n
            hit = self._shards[(x.data_ptr(), dim)] = (
                state, x.narrow(0, self.coordinate(dim) * rows, rows))
        return hit[1]


def make_mesh(n_data: int | None = None, n_model: int = 1,
              device: str | torch.device = "cuda") -> Mesh:
    """A ("data", "model") mesh over the process group that this process
    has joined: NCCL for CUDA devices, gloo for ``device="cpu"``, no
    fallback from one to the other.  ``n_data`` defaults to the world
    size over ``n_model``; ``n_data * n_model`` must be the world size (1
    is allowed).  Raises if there is no process group."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "torch.distributed.init_process_group first")
    backend = _BACKENDS[dev.type]
    if dist.get_backend() != backend:
        raise RuntimeError(f"a {dev.type} mesh runs over {backend}, and the process group "
                           f"uses {dist.get_backend()}")
    world = dist.get_world_size()
    if n_data is None:
        n_data = max(world // n_model, 1)
    if n_data * n_model != world:
        raise ValueError(f"a {n_data} x {n_model} mesh needs {n_data * n_model} processes, "
                         f"the group has {world}")
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", dist.get_rank() % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return Mesh(init_device_mesh(dev.type, (n_data, n_model), mesh_dim_names=DIMS), dev)


def data_sharding(mesh: Mesh, ndim: int = 2) -> tuple:
    """Placements over the mesh of a rank-`ndim` tensor whose leading
    (batch) axis is split over "data" and that is replicated over "model"."""
    return (Shard(0), Replicate())


def replicate_sharding(mesh: Mesh) -> tuple:
    """Placements of a tensor held whole by every process."""
    return (Replicate(), Replicate())


def shard_batch(batch, mesh: Mesh):
    """This process's slice of the leading axis of each tensor of `batch`
    (a tensor, or a dict, list or tuple of them), on the mesh's device.
    The leading size must be a multiple of ``mesh.shape["data"]``."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    n = mesh.shape["data"]
    if batch.shape[0] % n:
        raise ValueError(f"a batch of {batch.shape[0]} does not split over {n} data ranks")
    rows = batch.shape[0] // n
    return batch.narrow(0, mesh.coordinate("data") * rows, rows).to(mesh.device)
