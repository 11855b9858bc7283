"""Padded dense dataset for the DiffPool family and the baselines (port of
``coarsegrainingvae_tpu.data.diffpool``; DiffPoolDataset and
get_diffpool_data, data.py:84-183 and datasets.py:108-168 of the original
code).

Every frame shares one topology (z, bonds), so a batch is an index into the
frame axis: the bond adjacency is built once and tiled. The arrays are
numpy, built on the host with the JAX package's seeds; ``batch`` assembles
a ``DiffPoolBatch`` of CPU tensors, moved with ``.to(device)``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.dataset import rotate_frames
from coarsegrainingvae_tpu_torch.data.topology import angle_triplets, dihedral_quads_from_bonds


@dataclasses.dataclass
class DiffPoolBatch:
    """z (B, N) int64, xyz (B, N, 3) float32, adj (B, N, N) float32 bond
    adjacency, bonds (Eb, 2) the shared edge list of the graph loss,
    angles (A, 3) and dihedrals (Q, 4) the bonded index tuples (carried as
    the JAX package carries them; no loss reads them)."""

    z: torch.Tensor
    xyz: torch.Tensor
    adj: torch.Tensor
    bonds: torch.Tensor
    angles: Optional[torch.Tensor] = None
    dihedrals: Optional[torch.Tensor] = None

    def to(self, device) -> "DiffPoolBatch":
        return DiffPoolBatch(**{f.name: (None if getattr(self, f.name) is None
                                         else getattr(self, f.name).to(device))
                                for f in dataclasses.fields(self)})


@dataclasses.dataclass
class DiffPoolDatasetArrays:
    """Single-topology dense dataset."""

    z: np.ndarray       # (N,) int32
    xyz: np.ndarray     # (F, N, 3) float32
    bonds: np.ndarray   # (Eb, 2) undirected bonds (graph-loss edges)
    adj: np.ndarray     # (N, N) float32 bond adjacency
    angles: Optional[np.ndarray] = None      # (A, 3) bonded angle triplets
    dihedrals: Optional[np.ndarray] = None   # (Q, 4) proper dihedral quads

    def __len__(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.xyz.shape[1]

    def subset(self, idx: np.ndarray) -> "DiffPoolDatasetArrays":
        return dataclasses.replace(self, xyz=self.xyz[idx])

    def batch(self, idx: np.ndarray) -> DiffPoolBatch:
        b = idx.shape[0]

        def ids(a):
            return None if a is None else torch.from_numpy(np.asarray(a, np.int64))

        return DiffPoolBatch(
            z=torch.from_numpy(np.broadcast_to(self.z, (b,) + self.z.shape).astype(np.int64)),
            xyz=torch.from_numpy(np.ascontiguousarray(self.xyz[idx])),
            adj=torch.from_numpy(np.ascontiguousarray(
                np.broadcast_to(self.adj, (b,) + self.adj.shape))),
            bonds=ids(self.bonds), angles=ids(self.angles), dihedrals=ids(self.dihedrals),
        )

    def iter_batches(self, batch_size: int, rng: Optional[np.random.Generator] = None,
                     drop_last: bool = True) -> Iterator[DiffPoolBatch]:
        """Batches in order, or shuffled by ``rng``. A split smaller than a
        batch still yields one, wrap-padded from the order (np.resize)."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        stop = max(len(self) - batch_size + 1, 1) if drop_last else len(self)
        for lo in range(0, stop, batch_size):
            idx = order[lo:lo + batch_size]
            if idx.shape[0] < batch_size:
                idx = np.resize(np.concatenate([idx, order]), batch_size)
            yield self.batch(idx)


def build_diffpool_dataset(frames: np.ndarray, atomic_nums: np.ndarray, bonds: np.ndarray,
                           rotate: bool = False, shift: bool = False,
                           seed: int = 123) -> DiffPoolDatasetArrays:
    """Frames -> the dense dataset: each frame centred, then optionally
    rotated (``rotate_frames``) and shifted by a normal draw of seed + 1;
    the bond adjacency, angles and dihedrals from the bond list."""
    traj = np.asarray(frames, dtype=np.float32)
    traj = traj - traj.mean(axis=1, keepdims=True)
    if rotate:
        traj = rotate_frames(traj, seed)
    if shift:
        rng = np.random.default_rng(seed + 1)
        traj = traj + rng.normal(scale=1.0, size=(traj.shape[0], 1, 3)).astype(np.float32)

    n = traj.shape[1]
    bonds = np.asarray(bonds, dtype=np.int32)
    adj = np.zeros((n, n), dtype=np.float32)
    adj[bonds[:, 0], bonds[:, 1]] = 1.0
    adj[bonds[:, 1], bonds[:, 0]] = 1.0
    return DiffPoolDatasetArrays(
        z=np.asarray(atomic_nums, dtype=np.int32), xyz=traj, bonds=bonds, adj=adj,
        angles=angle_triplets(bonds, n), dihedrals=dihedral_quads_from_bonds(bonds, n),
    )
