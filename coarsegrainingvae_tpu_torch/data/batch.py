"""Fixed-shape padded batches (port of ``coarsegrainingvae_tpu.data.batch``).

The fields of the JAX ``CGBatch``. Index conventions are the JAX package's:
``mapping[b, i]`` is the CG bead of atom i, ``channel_idx[b, i]`` its
per-bead channel, ``bonds[b]`` the local (per-sample) graph-loss edges, and
``nbrs`` / ``cg_nbrs`` the directed, receiver-sorted radius graphs of the
atoms and the beads, which only the sparse model reads (the dense model
rebuilds its graphs inside the message kernels). A batch may leave the
graphs, or the bonds, None where nothing reads them.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch


@dataclass
class CGBatch:
    z: torch.Tensor            # (B, N) int64 atomic numbers; 0 = padding
    xyz: torch.Tensor          # (B, N, 3) float32
    atom_mask: torch.Tensor    # (B, N) bool
    cg_z: torch.Tensor         # (B, M) int64 bead ids
    cg_xyz: torch.Tensor       # (B, M, 3) float32
    cg_mask: torch.Tensor      # (B, M) bool
    mapping: torch.Tensor      # (B, N) int64
    channel_idx: torch.Tensor  # (B, N) int64
    bonds: Optional[torch.Tensor] = None      # (B, Eb, 2) int64
    bond_mask: Optional[torch.Tensor] = None  # (B, Eb) bool
    nbrs: Optional[torch.Tensor] = None         # (B, E, 2) int64, receiver-sorted
    nbr_mask: Optional[torch.Tensor] = None     # (B, E) bool
    cg_nbrs: Optional[torch.Tensor] = None      # (B, Ec, 2) int64, receiver-sorted
    cg_nbr_mask: Optional[torch.Tensor] = None  # (B, Ec) bool

    def to(self, device: Union[str, torch.device]) -> "CGBatch":
        def move(t):
            return None if t is None else t.to(device)

        return CGBatch(**{f.name: move(getattr(self, f.name))
                          for f in dataclasses.fields(self)})

    @property
    def batch_size(self) -> int:
        return self.z.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.z.shape[1]

    @property
    def n_cgs(self) -> int:
        return self.cg_z.shape[1]


def flatten_ids(local: torch.Tensor, stride: int) -> torch.Tensor:
    """Local per-sample indices (B, ...) -> global flat indices:
    global[b, k] = local[b, k] + b * stride, flattened over (B, k)."""
    b = local.shape[0]
    offsets = torch.arange(b, dtype=local.dtype, device=local.device) * stride
    out = local + offsets.reshape((b,) + (1,) * (local.ndim - 1))
    return out.reshape((-1,) + tuple(local.shape[2:]))


def pad_edges(edges: np.ndarray, max_edges: int) -> tuple[np.ndarray, np.ndarray]:
    """Pad an (e, 2) int edge list to (max_edges, 2) with zeros and a mask
    (the JAX package's helper, batch.py:82-91). Zero rows are not the
    port's receiver-sorted ``(n-1, n-1)`` tail, so no receiver-sorted path
    of the port uses it."""
    e = edges.shape[0]
    if e > max_edges:
        raise ValueError(f"edge list of size {e} exceeds budget {max_edges}")
    out = np.zeros((max_edges, 2), dtype=np.int32)
    mask = np.zeros((max_edges,), dtype=bool)
    out[:e] = edges
    mask[:e] = True
    return out, mask
