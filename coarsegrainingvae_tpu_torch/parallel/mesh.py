"""Ranks, process groups and sharding helpers (port of
``coarsegrainingvae_tpu.parallel.mesh``).

The JAX package shards one global-batch computation over a 1-D ('data',)
device mesh, or a 2-D ('data', 'model') one, and lets XLA insert the
collectives. Here a rank is one process with one device, and the
collectives are explicit ``torch.distributed`` calls on the mesh's process
groups: the trainer all-reduces one flat buffer per step (``train.trainer``),
ZeRO-1 all-gathers the update, tensor parallelism (``parallel.tensor``)
gathers features and parameter shards over the model axis, and the halo
stack (``parallel.halo``) swaps boundary rows with its ring neighbours.

``make_mesh(n, model_devices=m)`` folds the n ranks into a (n / m, m)
('data', 'model') mesh with the model axis minor, as the JAX package folds
its devices: rank r sits at (r // m, r % m). The mesh carries the rank's
two subgroups, its model group (the m ranks of its row, which see the same
rows of a batch) and its data group (the n / m ranks of its column);
``Mesh.data_axis`` and ``Mesh.model_axis`` are those groups as meshes of
their own, so every collective below works on either axis.

Transports follow the group's backend. NCCL takes device tensors for every
collective, and its collectives can be captured in a CUDA graph once its
communicator exists. Gloo takes CPU tensors for every collective but only
broadcast, all_reduce and barrier for CUDA tensors (torch.distributed's
backend table), so on gloo an all-gather is an all_reduce-sum of a
zero-filled buffer that holds each rank's part in place (exact: every other
addend is 0), and point-to-point traffic goes through host memory. A
collective that the backend refuses raises; nothing falls back to one
process.
"""
from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

# how long a collective may wait for its peers before it raises
TIMEOUT = datetime.timedelta(seconds=600)


@dataclass(frozen=True)
class Mesh:
    """One rank's view of a mesh: its rank, the mesh's size, the process
    group (None for a single process with no group), the group's backend
    and this rank's device. ``model_size`` > 1 makes it a (size /
    model_size, model_size) ('data', 'model') mesh whose rows are the
    model groups and whose columns the data groups (``model_group``,
    ``data_group``: this rank's)."""

    rank: int
    size: int
    group: Optional[dist.ProcessGroup]
    backend: Optional[str]
    device: torch.device
    model_size: int = 1
    data_group: Optional[dist.ProcessGroup] = None
    model_group: Optional[dist.ProcessGroup] = None

    @property
    def shape(self) -> Tuple[int, int]:
        """(data, model): the mesh's two axes."""
        return self.size // self.model_size, self.model_size

    @property
    def data_axis(self) -> "Mesh":
        """This rank's data group as a 1-D mesh: the ranks that hold the
        same model shards and train on different rows. The mesh itself
        when it has no model axis."""
        if self.model_size == 1:
            return self
        return Mesh(self.rank // self.model_size, self.size // self.model_size,
                    self.data_group, self.backend, self.device)

    @property
    def model_axis(self) -> "Mesh":
        """This rank's model group as a 1-D mesh: the ranks that see the
        same rows and hold one shard each of the sharded tensors."""
        if self.model_size == 1:
            return Mesh(0, 1, None, self.backend, self.device)
        return Mesh(self.rank % self.model_size, self.model_size, self.model_group,
                    self.backend, self.device)

    @property
    def transport(self) -> str:
        """How this mesh's all-gather and point-to-point traffic move."""
        if self.backend == "nccl":
            return "nccl: all_gather_into_tensor and batch_isend_irecv on device tensors"
        return ("gloo: all-gather as an all_reduce of a zero-filled buffer, "
                "point-to-point through host memory")


def init_distributed(device_type: str) -> bool:
    """Form the default process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR, MASTER_PORT; the device is cuda:LOCAL_RANK):
    NCCL for ``device_type`` "cuda", gloo for "cpu". Returns False, and
    does nothing, when WORLD_SIZE is unset or a process group exists (its
    former keeps it)."""
    if "WORLD_SIZE" not in os.environ or dist.is_initialized():
        return False
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl", timeout=TIMEOUT,
                                device_id=torch.device("cuda", torch.cuda.current_device()))
    else:
        dist.init_process_group("gloo", timeout=TIMEOUT)
    return True


def local_device(device_type: str) -> torch.device:
    """This rank's device: cuda:LOCAL_RANK under torchrun on a card, else
    the plain device."""
    if device_type == "cuda" and "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    return torch.device(device_type)


def make_mesh(num_devices: Optional[int] = None, model_devices: int = 1,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """The mesh: every rank of the default process group when
    ``torch.distributed`` is initialised (the JAX default of all devices),
    its first ``num_devices`` ranks as a subgroup when fewer are asked
    for; else one rank with no group. ``model_devices`` > 1 folds the ranks
    into a ('data', 'model') mesh (module docstring), forming every model
    and data group; every rank of the default group must call it alike.
    ``device`` defaults to cuda:LOCAL_RANK on NCCL, the CPU on gloo and the
    card for one rank."""
    if not dist.is_initialized():
        if num_devices not in (None, 1):
            raise ValueError(f"a mesh of {num_devices} ranks needs an initialised "
                             "torch.distributed process group")
        if model_devices > 1:
            raise ValueError(f"1 devices do not factor into model_devices={model_devices}")
        return Mesh(0, 1, None, None, torch.device(device or "cuda"))
    world, rank = dist.get_world_size(), dist.get_rank()
    backend = dist.get_backend()
    n = world if num_devices is None else num_devices
    if not 1 <= n <= world:
        raise ValueError(f"a mesh of {n} ranks in a world of {world}")
    if n % model_devices:
        raise ValueError(f"{n} devices do not factor into model_devices={model_devices}")
    group = dist.group.WORLD if n == world else dist.new_group(list(range(n)))
    if rank >= n:
        raise ValueError(f"rank {rank} is outside the mesh of the first {n} ranks")
    if device is None:
        device = local_device("cuda") if backend == "nccl" else torch.device("cpu")
    if model_devices == 1:
        return Mesh(rank, n, group, backend, torch.device(device))
    m = model_devices
    # every rank forms every group, in the same order (dist.new_group)
    rows = [dist.new_group(list(range(d * m, (d + 1) * m))) for d in range(n // m)]
    cols = [dist.new_group(list(range(j, n, m))) for j in range(m)]
    return Mesh(rank, n, group, backend, torch.device(device), model_size=m,
                data_group=cols[rank % m], model_group=rows[rank // m])


def shard_rows(n: int, mesh: Mesh) -> slice:
    """This rank's contiguous rows of a global batch of ``n`` (the JAX
    ``shard_batch``), split over the mesh's data axis only, so the ranks of
    one model group get the same rows; every row (replicated) when ``n``
    does not divide by the data axis."""
    data = mesh.data_axis
    if n % data.size:
        return slice(0, n)
    k = n // data.size
    return slice(data.rank * k, (data.rank + 1) * k)


def zero_partition(numel: int, mesh: Mesh) -> Tuple[slice, int]:
    """(this rank's slice, padded length) of a flat vector of ``numel``
    padded to a multiple of the world size: ZeRO-1's split of the
    optimizer state (the JAX ``zero_shardings``). Adam is elementwise, so a
    flat slice computes what a per-leaf split does."""
    chunk = -(-numel // mesh.size)
    return slice(mesh.rank * chunk, (mesh.rank + 1) * chunk), chunk * mesh.size


def _global(mesh: Mesh, rank: int) -> int:
    return dist.get_global_rank(mesh.group, rank) if mesh.group is not dist.group.WORLD else rank


def all_reduce_(t: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Sum ``t`` over the mesh, in place; ``t`` itself on a mesh with no
    group."""
    if mesh.group is not None:
        dist.all_reduce(t, group=mesh.group)
    return t


def replicate(tensors: Sequence[torch.Tensor], mesh: Mesh) -> None:
    """Broadcast ``tensors`` from rank 0, in place, as one flat buffer."""
    with torch.no_grad():
        flat = torch.cat([t.detach().reshape(-1) for t in tensors])
        dist.broadcast(flat, src=_global(mesh, 0), group=mesh.group)
        for t, part in zip(tensors, torch.split(flat, [t.numel() for t in tensors])):
            t.copy_(part.view_as(t))


def all_gather_(out: torch.Tensor, part: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """out (size * k,) <- every rank's ``part`` (k,), in rank order."""
    if mesh.backend == "nccl":
        dist.all_gather_into_tensor(out, part, group=mesh.group)
        return out
    k = part.numel()
    out.zero_()
    out[mesh.rank * k:(mesh.rank + 1) * k].copy_(part)
    return all_reduce_(out, mesh)


def ring_exchange(to_next: torch.Tensor, to_prev: torch.Tensor,
                  mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Send ``to_next`` to rank + 1 and ``to_prev`` to rank - 1; returns
    (what rank - 1 sent, what rank + 1 sent), zeros at the open ends of the
    ring (the JAX ``ppermute``'s missing-source semantics)."""
    host = mesh.backend != "nccl"

    def stage(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to("cpu" if host else t.device).contiguous()

    from_prev = torch.zeros_like(stage(to_next))
    from_next = torch.zeros_like(stage(to_prev))
    ops: List[dist.P2POp] = []
    if mesh.rank + 1 < mesh.size:
        peer = _global(mesh, mesh.rank + 1)
        ops += [dist.P2POp(dist.isend, stage(to_next), peer, mesh.group),
                dist.P2POp(dist.irecv, from_next, peer, mesh.group)]
    if mesh.rank > 0:
        peer = _global(mesh, mesh.rank - 1)
        ops += [dist.P2POp(dist.isend, stage(to_prev), peer, mesh.group),
                dist.P2POp(dist.irecv, from_prev, peer, mesh.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return from_prev.to(to_next.device), from_next.to(to_prev.device)


class RowNoise:
    """Stand-in for a generator under data parallelism: the model's noise
    for rows ``rows`` of a global batch of ``n_frames``. ``draw`` draws
    the global batch's standard normals from ``generator``, as one rank
    would for the whole batch, and keeps this rank's rows, so every rank
    trains on the draws of the one global-batch step."""

    def __init__(self, generator: Optional[torch.Generator], n_frames: int, rows: slice):
        self.generator, self.n_frames, self.rows = generator, n_frames, rows

    def draw(self, like: torch.Tensor) -> torch.Tensor:
        per = like.shape[0] // (self.rows.stop - self.rows.start)   # rows per frame
        full = torch.randn((self.n_frames * per,) + tuple(like.shape[1:]),
                           generator=self.generator, device=like.device, dtype=like.dtype)
        return full[self.rows.start * per:self.rows.stop * per]
