"""Array-backed dataset and fixed-shape batching (port of
``coarsegrainingvae_tpu.data.dataset``).

The dataset is numpy arrays, as in the JAX package, built once on the host:
rotation augmentation, CG coordinates, radius graphs and the high-order
bonded edges of the graph loss. The same seeds give the same arrays.
``CGDatasetArrays.batch`` assembles a torch ``CGBatch`` on the CPU; move it
with ``.to(device)``, or keep the frames on the device with
``data.device.DeviceDataset``.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.neighbors import make_directed, radius_graph_frames
from coarsegrainingvae_tpu_torch.data.topology import (
    cg_graph_from_bonds,
    channel_index_from_mapping,
    high_order_edges,
)
from coarsegrainingvae_tpu_torch.utils import tracing


@dataclasses.dataclass
class CGDatasetArrays:
    """Single-topology dataset: every frame shares (z, mapping, bonds).

    Shapes: xyz (F,N,3), cg_xyz (F,M,3), nbrs (F,E,2)+mask, cg_nbrs
    (F,Ec,2)+mask; z/mapping/channel_idx (N,), bonds (Eb,2).
    """

    z: np.ndarray
    xyz: np.ndarray
    cg_xyz: np.ndarray
    mapping: np.ndarray
    channel_idx: np.ndarray
    bonds: np.ndarray
    nbrs: np.ndarray
    nbr_mask: np.ndarray
    cg_nbrs: np.ndarray
    cg_nbr_mask: np.ndarray
    n_cgs: int
    # optional per-frame aux edges replacing the bonded graph-loss edges
    # (generate_aux_edges, data.py:199-205 of the original code)
    aux_bonds: Optional[np.ndarray] = None   # (F, Ea, 2)
    aux_mask: Optional[np.ndarray] = None    # (F, Ea)

    def __len__(self) -> int:
        return self.xyz.shape[0]

    @property
    def n_atoms(self) -> int:
        return self.xyz.shape[1]

    def subset(self, idx: np.ndarray) -> "CGDatasetArrays":
        return dataclasses.replace(
            self,
            xyz=self.xyz[idx],
            cg_xyz=self.cg_xyz[idx],
            nbrs=self.nbrs[idx],
            nbr_mask=self.nbr_mask[idx],
            cg_nbrs=self.cg_nbrs[idx],
            cg_nbr_mask=self.cg_nbr_mask[idx],
            aux_bonds=None if self.aux_bonds is None else self.aux_bonds[idx],
            aux_mask=None if self.aux_mask is None else self.aux_mask[idx],
        )

    def batch(self, idx: np.ndarray) -> CGBatch:
        """A fixed-shape CGBatch (on the CPU) for frame indices idx."""
        b = idx.shape[0]
        n, m = self.n_atoms, self.n_cgs

        def tile(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, dtype=torch.long).expand((b,) + a.shape)

        if self.aux_bonds is None:
            bonds = tile(self.bonds)
            bond_mask = torch.ones((b, self.bonds.shape[0]), dtype=torch.bool)
        else:
            bonds = torch.as_tensor(self.aux_bonds[idx], dtype=torch.long)
            bond_mask = torch.as_tensor(self.aux_mask[idx])
        return CGBatch(
            z=tile(self.z),
            xyz=torch.as_tensor(self.xyz[idx], dtype=torch.float32),
            atom_mask=torch.ones((b, n), dtype=torch.bool),
            cg_z=tile(np.arange(m)),
            cg_xyz=torch.as_tensor(self.cg_xyz[idx], dtype=torch.float32),
            cg_mask=torch.ones((b, m), dtype=torch.bool),
            mapping=tile(self.mapping),
            channel_idx=tile(self.channel_idx),
            bonds=bonds,
            bond_mask=bond_mask,
            nbrs=torch.as_tensor(self.nbrs[idx], dtype=torch.long),
            nbr_mask=torch.as_tensor(self.nbr_mask[idx]),
            cg_nbrs=torch.as_tensor(self.cg_nbrs[idx], dtype=torch.long),
            cg_nbr_mask=torch.as_tensor(self.cg_nbr_mask[idx]),
        )

    def iter_batches(
        self,
        batch_size: int,
        rng: Optional[np.random.Generator] = None,
        drop_last: bool = True,
    ) -> Iterator[CGBatch]:
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        # always yield at least one (padded) batch, even when the
        # split is smaller than batch_size
        stop = max(len(self) - batch_size + 1, 1) if drop_last else len(self)
        for lo in range(0, stop, batch_size):
            idx = order[lo : lo + batch_size]
            if idx.shape[0] < batch_size:
                # pad by cycling: these are full frames that re-enter the
                # epoch average
                idx = np.resize(np.concatenate([idx, order]), batch_size)
            yield self.batch(idx)


def rotate_frames(traj: np.ndarray, seed: int = 123) -> np.ndarray:
    """Per-frame random rotation augmentation about the frame centroid
    (random_rotation, datasets.py:65-71 of the original code)."""
    traj = np.asarray(traj, dtype=np.float32)
    f = traj.shape[0]
    rng = np.random.default_rng(seed)
    vec = rng.normal(size=(f, 3))
    axis = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
    angle = np.deg2rad(rng.integers(-180, 180, size=f).astype(np.float64))
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    x, y, z_ = axis[:, 0], axis[:, 1], axis[:, 2]
    rot = np.stack(
        [
            np.stack([c + x * x * C, x * y * C - z_ * s, x * z_ * C + y * s], -1),
            np.stack([y * x * C + z_ * s, c + y * y * C, y * z_ * C - x * s], -1),
            np.stack([z_ * x * C - y * s, z_ * y * C + x * s, c + z_ * z_ * C], -1),
        ],
        axis=-2,
    )
    center = traj.mean(axis=1, keepdims=True)
    return np.einsum(
        "fni,fij->fnj", traj - center, np.swapaxes(rot, -1, -2)
    ).astype(np.float32) + center.astype(np.float32)


def _segment_mean_np(x: np.ndarray, seg: np.ndarray, m: int) -> np.ndarray:
    """Per-frame scatter_mean over atoms: x (F,N,3), seg (N,) -> (F,m,3)."""
    out = np.zeros((x.shape[0], m, x.shape[2]), dtype=x.dtype)
    for k in range(m):
        sel = seg == k
        out[:, k] = x[:, sel].mean(axis=1)
    return out


@tracing.span("data.build_dataset")
def build_dataset(
    mapping: np.ndarray,
    traj: np.ndarray,
    atom_cutoff: float,
    cg_cutoff: Optional[float],
    atomic_nums: np.ndarray,
    bonds: np.ndarray,
    order: int = 1,
    cg_traj: Optional[np.ndarray] = None,
    rotate: bool = True,
    seed: int = 123,
    max_atom_edges: Optional[int] = None,
    max_cg_edges: Optional[int] = None,
    aux_cutoff: Optional[float] = None,
) -> CGDatasetArrays:
    """Frames -> preprocessed arrays (build_dataset, datasets.py:459-506 +
    CGDataset.generate_neighbor_list, data.py:207-251 of the original code).

    - optional per-frame random rotation augmentation
    - CG coordinates = per-bead mean unless cg_traj given
    - atom radius graph at atom_cutoff (directed, padded)
    - CG radius graph at cg_cutoff, or the bond-contracted CG graph when
      cg_cutoff is None
    - bonded edges expanded to graph distance <= order

    Each call is recorded as the span ``data.build_dataset`` (``utils.tracing``).
    """
    traj = np.asarray(traj, dtype=np.float32)
    f, n, _ = traj.shape
    mapping = np.asarray(mapping, dtype=np.int32)
    n_cgs = int(mapping.max()) + 1

    if rotate:
        traj = rotate_frames(traj, seed)

    if cg_traj is not None:
        cg_xyz = np.asarray(cg_traj, dtype=np.float32)
    else:
        cg_xyz = _segment_mean_np(traj, mapping, n_cgs).astype(np.float32)

    hyper = high_order_edges(np.asarray(bonds, dtype=np.int64), order, n)

    nbrs, nbr_mask = radius_graph_frames(
        traj, atom_cutoff, max_edges=max_atom_edges, directed=True
    )

    if cg_cutoff is not None:
        cg_nbrs, cg_nbr_mask = radius_graph_frames(
            cg_xyz, cg_cutoff, max_edges=max_cg_edges, directed=True
        )
    else:
        cg_e = make_directed(cg_graph_from_bonds(np.asarray(bonds), mapping, n, n_cgs))
        cg_e = cg_e[np.argsort(cg_e[:, 0], kind="stable")]  # receiver-sorted
        cg_nbrs = np.broadcast_to(cg_e, (f,) + cg_e.shape).copy()
        cg_nbr_mask = np.ones((f, cg_e.shape[0]), dtype=bool)

    aux_bonds = aux_mask = None
    if aux_cutoff is not None and aux_cutoff > 0.0:
        aux_bonds, aux_mask = radius_graph_frames(
            traj, aux_cutoff, directed=False
        )

    return CGDatasetArrays(
        z=np.asarray(atomic_nums, dtype=np.int32),
        xyz=traj,
        cg_xyz=cg_xyz,
        mapping=mapping,
        channel_idx=channel_index_from_mapping(mapping),
        bonds=np.asarray(hyper, dtype=np.int32),
        nbrs=nbrs,
        nbr_mask=nbr_mask,
        cg_nbrs=cg_nbrs,
        cg_nbr_mask=cg_nbr_mask,
        n_cgs=n_cgs,
        aux_bonds=aux_bonds,
        aux_mask=aux_mask,
    )


def kfold_indices(n: int, nsplits: int, seed: int = 123) -> Sequence[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic K-fold split (the original code uses sklearn KFold,
    run_ala.py:139-141)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    folds = np.array_split(order, nsplits)
    out = []
    for k in range(nsplits):
        test = folds[k]
        train = np.concatenate([folds[j] for j in range(nsplits) if j != k])
        out.append((np.sort(train), np.sort(test)))
    return out
