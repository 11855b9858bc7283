"""Model outputs and the flat graph the loss reads (port of part of
``coarsegrainingvae_tpu.models.cgvae``).

``VAEOutput``, ``FlatGraph``, ``flatten_batch`` and
``build_flagship_model`` are ported; the sparse ``CGequiVAE`` is listed in
ROADMAP.md (A9). ``FlatGraph`` carries only the fields the loss reads; the
flattened radius graphs wait for the sparse model.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from coarsegrainingvae_tpu_torch.config import ModelConfig
from coarsegrainingvae_tpu_torch.data.batch import CGBatch, flatten_ids


@dataclass
class FlatGraph:
    """A CGBatch flattened to one global graph."""

    z: torch.Tensor          # (BN,)
    xyz: torch.Tensor        # (BN, 3)
    atom_mask: torch.Tensor  # (BN,)
    cg_mask: torch.Tensor    # (BM,)
    bonds: torch.Tensor      # (BEb, 2) global atom ids
    bond_mask: torch.Tensor  # (BEb,)


def flatten_batch(batch: CGBatch) -> FlatGraph:
    n = batch.z.shape[1]
    return FlatGraph(
        z=batch.z.reshape(-1),
        xyz=batch.xyz.reshape(-1, 3),
        atom_mask=batch.atom_mask.reshape(-1),
        cg_mask=batch.cg_mask.reshape(-1),
        bonds=flatten_ids(batch.bonds, n),
        bond_mask=batch.bond_mask.reshape(-1),
    )


@dataclass
class VAEOutput:
    """Flattened model outputs: per-bead (B*M, F) latent statistics and
    per-atom (B*N, 3) coordinates."""

    mu: Optional[torch.Tensor]
    sigma: Optional[torch.Tensor]
    prior_mu: Optional[torch.Tensor]
    prior_sigma: Optional[torch.Tensor]
    xyz: torch.Tensor
    xyz_recon: torch.Tensor


def build_flagship_model(cfg: ModelConfig, force_sparse: bool = False,
                         generator: Optional[torch.Generator] = None):
    """The one place that picks the model class for a config, used by the
    training CLI and by checkpoint reloading (``cli/postanalysis.py``,
    ``Backmapper.from_run``), which must rebuild the parameters the run
    trained. The JAX package picks the sparse ``CGequiVAE`` for
    ``force_sparse``, ``cfg.sparse`` and the pseudo2/en/inv decoders; the
    port has only the dense model, so those raise. Parameters are drawn on
    the CPU from ``generator``."""
    if force_sparse or cfg.sparse or cfg.dec_type in ("pseudo2", "en", "inv"):
        raise NotImplementedError(
            f"the sparse CGequiVAE (sparse={force_sparse or cfg.sparse}, "
            f"dec_type={cfg.dec_type!r}) is not ported to PyTorch yet; see "
            "ROADMAP.md A9")
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE

    return DenseCGVAE(cfg, generator=generator)
