"""Atom-sharded message passing with a halo exchange (port of
``coarsegrainingvae_tpu.parallel.halo``).

Beyond ~100k atoms one device cannot hold a frame's message-passing working
set, and data parallelism does not help: it splits frames, not a frame's
atoms. This module splits the atoms, as molecular dynamics splits space:

1. On the host, once per topology (``plan_halo``, numpy, the JAX package's
   arrays bit for bit): sort the atoms along the frame's longest box axis
   so each rank owns a contiguous slab. With a cutoff much smaller than a
   slab, every cross-slab edge joins adjacent slabs only: a ring. A rank's
   working set is [left halo | local | right halo] with a fixed halo width
   H; its edges are remapped into that extended index space,
   receiver-sorted and padded to one static shape with self-loops on the
   last local atom, which keeps them sorted for ``ops.segment``'s CSR
   sums.
2. On each rank (``halo_message``, ``HaloEquiStack``): ``ring_exchange``
   sends the last H local rows to rank + 1 and the first H to rank - 1
   (the JAX ``ppermute``; zeros at the open ends, which no edge reads),
   the unchanged sparse blocks of ``models.conv`` run on the extended
   rows, and only the local receivers are kept. Traffic per layer is
   O(H * F) per rank, not the O(N * F) an all-gather of node features
   would move. ``_Exchange``'s backward is the transpose: the halo rows'
   cotangents go back around the ring and are added into their owners'
   boundary rows.

Unlike the JAX package's ``shard_map``, where one call takes and returns
the whole sharded array, each rank here is a process: it passes its own
block of ``plan.shard_size`` rows (``plan.block``) and gets its block
back. ``EquiStack`` is the unsharded stack whose parameters the sharded
one applies (``convert.convert_equistack_params`` reads the JAX
package's ``EquiStack`` tree).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
from torch import nn

from coarsegrainingvae_tpu_torch.models.conv import EquiMessageBlock, UpdateBlock
from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh, make_mesh, ring_exchange


@dataclasses.dataclass(frozen=True)
class HaloPlan:
    """Host-side atom partition for one topology (all numpy, static)."""

    n_shards: int
    shard_size: int          # P: atoms per shard (of the padded count)
    halo: int                # H: boundary atoms exchanged with each neighbour
    order: np.ndarray        # (Np,) sharded index -> original (ghosts -> n)
    inv_order: np.ndarray    # (N,) original index -> sharded index
    edges: np.ndarray        # (D, E, 2) int32 per-shard [recv_ext, send_ext]
    edge_mask: np.ndarray    # (D, E) bool, False on padding
    n_atoms: int = 0         # N: real atoms (Np = n_shards * shard_size)

    @property
    def ext_size(self) -> int:
        return self.shard_size + 2 * self.halo

    @property
    def n_padded(self) -> int:
        return self.n_shards * self.shard_size

    def pad(self, x: np.ndarray) -> np.ndarray:
        """(N, ...) array in original order -> (Np, ...) in sharded order
        (ghost rows zero). Inverse: take [inv_order] of the result."""
        x = np.asarray(x)
        out = np.zeros((self.n_padded,) + x.shape[1:], x.dtype)
        real = self.order < self.n_atoms
        out[real] = x[self.order[real]]
        return out

    def block(self, x, rank: int):
        """Rank ``rank``'s rows of a (Np, ...) sharded-order array."""
        return x[rank * self.shard_size:(rank + 1) * self.shard_size]


def plan_halo(xyz: np.ndarray, edges: np.ndarray, n_shards: int, halo: int) -> HaloPlan:
    """Partition one frame's atoms into n_shards contiguous spatial slabs.

    xyz: (N, 3) representative coordinates (any frame: the partition
    needs rough locality only; the radius graph ``edges`` (E, 2) of
    directed [receiver, sender] pairs decides correctness). N that does
    not divide by n_shards is padded with edge-less ghost atoms sorted
    last (zero rows via ``plan.pad``). Raises if an edge reaches beyond
    the +-1-neighbour halo: raise ``halo`` (``min_halo`` gives the least
    that works) or lower the cutoff. The check is exact."""
    xyz = np.asarray(xyz)
    n = xyz.shape[0]
    n_pad = (-n) % n_shards
    axis = int(np.argmax(xyz.max(0) - xyz.min(0)))
    order = np.argsort(xyz[:, axis], kind="stable").astype(np.int32)
    if n_pad:
        # ghost atoms (index n) sort last: they own no edges, and appending
        # them at the tail displaces no real atom across a slab boundary
        order = np.concatenate([order, np.full(n_pad, n, np.int32)])
    p = (n + n_pad) // n_shards
    if halo > p:
        raise ValueError(f"halo {halo} exceeds shard size {p}")
    inv_order = np.empty(n, np.int32)
    inv_order[order[:n]] = np.arange(n, dtype=np.int32)  # ghosts sit at the tail

    e = inv_order[np.asarray(edges, np.int64)]  # edges in sharded space
    recv_shard = e[:, 0] // p
    span = np.abs(e[:, 1] - e[:, 0])
    # exact reachability: a sender must live inside its receiver's
    # extended window [d*p - halo, (d+1)*p + halo)
    lo = recv_shard * p - halo
    hi = (recv_shard + 1) * p + halo
    bad = (e[:, 1] < lo) | (e[:, 1] >= hi)
    if bad.any():
        worst = int(span[bad].max())
        raise ValueError(
            f"{int(bad.sum())} edges reach beyond the halo "
            f"(max span {worst} atoms, halo {halo}, shard {p}); raise "
            "`halo` or use a smaller cutoff/denser shards"
        )

    per_shard = []
    for d in range(n_shards):
        sel = recv_shard == d
        ed = e[sel]
        base = d * p - halo  # extended-space origin of this shard
        recv_ext = ed[:, 0] - base
        send_ext = ed[:, 1] - base
        o = np.argsort(recv_ext, kind="stable")  # receiver-sorted invariant
        per_shard.append(np.stack([recv_ext[o], send_ext[o]], 1))
    e_max = max(len(x) for x in per_shard) if per_shard else 1
    out = np.full((n_shards, e_max, 2), 0, np.int32)
    mask = np.zeros((n_shards, e_max), bool)
    for d, ed in enumerate(per_shard):
        out[d, : len(ed)] = ed
        # sorted-tail padding: a self-loop on the last local atom keeps the
        # receiver-sorted invariant (data/neighbors.py discipline)
        out[d, len(ed):] = halo + p - 1
        mask[d, : len(ed)] = True
    return HaloPlan(
        n_shards=n_shards, shard_size=p, halo=halo, order=order,
        inv_order=inv_order, edges=out, edge_mask=mask, n_atoms=n,
    )


def min_halo(xyz: np.ndarray, edges: np.ndarray, n_shards: int) -> int:
    """The least halo for which ``plan_halo`` takes this graph (at least
    1): the farthest any sender sits outside its receiver's slab."""
    xyz = np.asarray(xyz)
    n = xyz.shape[0]
    p = (n + (-n) % n_shards) // n_shards
    axis = int(np.argmax(xyz.max(0) - xyz.min(0)))
    inv_order = np.empty(n, np.int64)
    inv_order[np.argsort(xyz[:, axis], kind="stable")] = np.arange(n)
    e = inv_order[np.asarray(edges, np.int64)]
    d = e[:, 0] // p
    reach = np.maximum(d * p - e[:, 1], e[:, 1] - (d + 1) * p + 1)
    return max(int(reach.max(initial=0)), 1)


class _Exchange(torch.autograd.Function):
    """[left halo | block | right halo] of one rank's block; the backward
    sends the halos' cotangents back to their owners (``ppermute``'s
    transpose)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
        ctx.halo, ctx.mesh = halo, mesh
        left, right = ring_exchange(x[-halo:], x[:halo], mesh)
        return torch.cat([left, x, right], dim=0)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        h = ctx.halo
        g = g.contiguous()
        # my left halo came from rank - 1's last rows, my right halo from
        # rank + 1's first rows: send each cotangent back to its owner
        from_prev, from_next = ring_exchange(g[-h:], g[:h], ctx.mesh)
        dx = g[h:-h].clone()
        dx[:h] += from_prev
        dx[-h:] += from_next
        return dx, None, None


def exchange(x: torch.Tensor, halo: int, mesh: Mesh) -> torch.Tensor:
    """[left halo | x | right halo] for this rank's block ``x``
    (differentiable)."""
    return _Exchange.apply(x, halo, mesh)


def _rank_edges(plan: HaloPlan, mesh: Mesh, device) -> Tuple[torch.Tensor, torch.Tensor]:
    return (torch.as_tensor(plan.edges[mesh.rank], dtype=torch.long, device=device),
            torch.as_tensor(plan.edge_mask[mesh.rank], device=device))


def halo_message(module: nn.Module, s: torch.Tensor, v: torch.Tensor, xyz: torch.Tensor,
                 plan: HaloPlan, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """One sparse message pass (a ``models.conv`` edge block, e.g.
    ``EquiMessageBlock``) over atom-sharded inputs. s (P, F), v (P, 3, F)
    and xyz (P, 3) are this rank's block of the plan's sharded order
    (``plan.block(plan.pad(x), rank)``); returns this rank's (ds, dv) in
    the same order (``out[plan.inv_order]`` of the blocks in rank order
    restores the original order)."""
    h, p = plan.halo, plan.shard_size
    edges, emask = _rank_edges(plan, mesh, s.device)
    xyz_ext = exchange(xyz, h, mesh)
    r_ij = xyz_ext[edges[:, 1]] - xyz_ext[edges[:, 0]]
    ds, dv = module(exchange(s, h, mesh), exchange(v, h, mesh), r_ij, edges, emask)
    return ds[h:h + p], dv[h:h + p]


def make_atom_mesh(n_devices: int) -> Mesh:
    """The mesh of the first ``n_devices`` ranks, one slab each."""
    return make_mesh(n_devices)


class EquiStack(nn.Module):
    """Unsharded n_conv x (message + update) residual PaiNN stack: the
    encoder's conv loop (cgvae.py:194-331 of the original code) without the
    CG contraction, which stays frame-global. ``HaloEquiStack`` runs the
    same parameters atom-sharded."""

    def __init__(self, n_conv: int, feat_dim: int, n_rbf: int, activation: str,
                 cutoff: float, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.msgs = nn.ModuleList(
            EquiMessageBlock(feat_dim, activation, n_rbf, cutoff, dtype=dtype,
                             generator=generator) for _ in range(n_conv))
        self.updates = nn.ModuleList(
            UpdateBlock(feat_dim, activation, dtype, generator) for _ in range(n_conv))

    def forward(self, s, v, xyz, edges, edge_mask=None):
        r_ij = xyz[edges[:, 1]] - xyz[edges[:, 0]]
        for msg, upd in zip(self.msgs, self.updates):
            ds, dv = msg(s, v, r_ij, edges, edge_mask)
            s, v = s + ds, v + dv
            us, uv = upd(s, v)
            s, v = s + us, v + uv
        return s, v


class HaloEquiStack(nn.Module):
    """``stack`` atom-sharded over ``mesh`` by ``plan``: the halos are
    refreshed before each message layer (features change between layers);
    the node update is per node and runs on the local rows only. Traffic
    per step: O(n_conv * H * F) per rank."""

    def __init__(self, stack: EquiStack, plan: HaloPlan, mesh: Mesh):
        super().__init__()
        self.stack, self.plan, self.mesh = stack, plan, mesh

    def forward(self, s, v, xyz):
        h, p = self.plan.halo, self.plan.shard_size
        edges, emask = _rank_edges(self.plan, self.mesh, s.device)
        xyz_ext = exchange(xyz, h, self.mesh)
        r_ij = xyz_ext[edges[:, 1]] - xyz_ext[edges[:, 0]]
        for msg, upd in zip(self.stack.msgs, self.stack.updates):
            ds, dv = msg(exchange(s, h, self.mesh), exchange(v, h, self.mesh), r_ij, edges,
                         emask)
            s, v = s + ds[h:h + p], v + dv[h:h + p]
            us, uv = upd(s, v)
            s, v = s + us, v + uv
        return s, v


def halo_stack_apply(stack: EquiStack, s: torch.Tensor, v: torch.Tensor, xyz: torch.Tensor,
                     plan: HaloPlan, mesh: Mesh) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run ``stack`` atom-sharded: this rank's blocks in, its blocks of
    (s, v) out, in the plan's sharded order."""
    return HaloEquiStack(stack, plan, mesh)(s, v, xyz)
