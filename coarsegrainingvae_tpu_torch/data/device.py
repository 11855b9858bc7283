"""Device-resident dataset (port of ``coarsegrainingvae_tpu.data.device``).

For single-topology datasets that fit in device memory, every frame lives on
the device once and a training batch is gathered there from a (B,) index
tensor: no host work per step. Per-topology arrays (z, mapping, channel
index, bonds) are stored once and broadcast to the batch; the per-frame
radius graphs (nbrs, cg_nbrs), which the sparse model reads, are gathered
with the frames.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays


@dataclass
class DeviceDataset:
    xyz: torch.Tensor          # (F, N, 3) float32
    cg_xyz: torch.Tensor       # (F, M, 3) float32
    z: torch.Tensor            # (N,) int64
    cg_z: torch.Tensor         # (M,) int64
    mapping: torch.Tensor      # (N,) int64
    channel_idx: torch.Tensor  # (N,) int64
    bonds: torch.Tensor        # (Eb, 2) int64
    nbrs: torch.Tensor         # (F, E, 2) int64
    nbr_mask: torch.Tensor     # (F, E) bool
    cg_nbrs: torch.Tensor      # (F, Ec, 2) int64
    cg_nbr_mask: torch.Tensor  # (F, Ec) bool
    n_frames: int

    @classmethod
    def from_dataset(cls, ds: CGDatasetArrays,
                     device: Union[str, torch.device]) -> "DeviceDataset":
        if ds.aux_bonds is not None:
            raise ValueError("per-frame aux edges are not held on the device; "
                             "stream such a dataset with CGDatasetArrays.batch")

        def put(a, dtype):
            return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)

        return cls(
            xyz=put(ds.xyz, torch.float32),
            cg_xyz=put(ds.cg_xyz, torch.float32),
            z=put(ds.z, torch.long),
            cg_z=put(np.arange(ds.n_cgs), torch.long),
            mapping=put(ds.mapping, torch.long),
            channel_idx=put(ds.channel_idx, torch.long),
            bonds=put(ds.bonds, torch.long),
            nbrs=put(ds.nbrs, torch.long),
            nbr_mask=put(ds.nbr_mask, torch.bool),
            cg_nbrs=put(ds.cg_nbrs, torch.long),
            cg_nbr_mask=put(ds.cg_nbr_mask, torch.bool),
            n_frames=len(ds),
        )

    def gather(self, idx: torch.Tensor) -> CGBatch:
        """The CGBatch of frame indices idx (a (B,) int64 tensor on the
        dataset's device); only device ops, no host synchronisation."""
        b = idx.shape[0]
        device = self.xyz.device

        def tile(a: torch.Tensor) -> torch.Tensor:
            return a.expand((b,) + tuple(a.shape))

        return CGBatch(
            z=tile(self.z),
            xyz=self.xyz.index_select(0, idx),
            atom_mask=torch.ones((b, self.z.shape[0]), dtype=torch.bool, device=device),
            cg_z=tile(self.cg_z),
            cg_xyz=self.cg_xyz.index_select(0, idx),
            cg_mask=torch.ones((b, self.cg_z.shape[0]), dtype=torch.bool, device=device),
            mapping=tile(self.mapping),
            channel_idx=tile(self.channel_idx),
            bonds=tile(self.bonds),
            bond_mask=torch.ones((b, self.bonds.shape[0]), dtype=torch.bool, device=device),
            nbrs=self.nbrs.index_select(0, idx),
            nbr_mask=self.nbr_mask.index_select(0, idx),
            cg_nbrs=self.cg_nbrs.index_select(0, idx),
            cg_nbr_mask=self.cg_nbr_mask.index_select(0, idx),
        )


def epoch_index_batches(
    n_frames: int, batch_size: int, rng: Optional[np.random.Generator]
) -> np.ndarray:
    """(S, B) int32 frame indices covering one epoch (shuffled when rng
    given, short tail cycled)."""
    order = np.arange(n_frames)
    if rng is not None:
        rng.shuffle(order)
    n_steps = max(n_frames // batch_size, 1)
    need = n_steps * batch_size
    if need > n_frames:
        order = np.resize(order, need)
    return order[:need].reshape(n_steps, batch_size).astype(np.int32)
