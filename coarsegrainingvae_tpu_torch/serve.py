"""Inference/serving: backmap CG coordinates to all-atom ensembles (port of
``coarsegrainingvae_tpu.serve``).

    bm = Backmapper.from_run("run/modelparams.json", "run/fold0")
    ensemble = bm.backmap(cg_xyz, n_samples=16, seed=0)   # (16, N, 3)

reads a fold that ``cli.run_cgvae`` trained; a model whose parameters are
already loaded (e.g. ``convert.convert_flax_params`` of a JAX model's) is
served with ``Backmapper(model, mapping, atomic_nums, cfg)``.

Generation needs only CG geometry (prior -> decode -> channel lift); atom
coordinates are not required, except as bond lengths for the H
bond-length projection (``bonds``, ``ref_xyz``). On a CUDA device every
message layer of the dense model is one launch of a hand-written kernel;
the sparse ``CGequiVAE`` reads the CG radius graph each batch carries.
"""
from __future__ import annotations

import json
import os
import warnings
from typing import Optional, Union

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import ExperimentConfig
from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.neighbors import radius_graph_frames
from coarsegrainingvae_tpu_torch.data.topology import channel_index_from_mapping
from coarsegrainingvae_tpu_torch.models.cgvae import project_batch_h_bonds
from coarsegrainingvae_tpu_torch.utils.rng import generator


class Backmapper:
    """CG -> all-atom generator around a DenseCGVAE or CGequiVAE whose
    parameters are already loaded. The model is moved to ``device`` (the
    card unless the caller passes ``device="cpu"``; without a card the
    default raises) and put in eval mode.

    bonds (Eb, 2) and ref_xyz (N, 3), one true frame: the H bond-length
    projection (``h_project``, ``h_project_eval``) reads bond lengths from
    them. A config that projects without them warns, and its ensembles
    carry the decoder's raw hydrogens."""

    def __init__(self, model: torch.nn.Module, mapping: np.ndarray,
                 atomic_nums: np.ndarray, cfg: ExperimentConfig,
                 device: Union[str, torch.device] = "cuda",
                 bonds: Optional[np.ndarray] = None,
                 ref_xyz: Optional[np.ndarray] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()
        self.cfg = cfg
        self.mapping = np.asarray(mapping, np.int64)
        self.z = np.asarray(atomic_nums, np.int64)
        self.n_atoms = self.mapping.shape[0]
        self.n_cgs = int(self.mapping.max()) + 1
        self.channel_idx = channel_index_from_mapping(self.mapping).astype(np.int64)
        self.bonds = None if bonds is None else np.asarray(bonds, np.int64).reshape(-1, 2)
        self.ref_xyz = None if ref_xyz is None else np.asarray(ref_xyz, np.float32)
        if (cfg.model.h_project or cfg.model.h_project_eval) and (
                self.bonds is None or self.ref_xyz is None):
            warnings.warn(
                "Backmapper: the run config enables H bond-length projection but "
                "no bonds/ref_xyz were provided -- served ensembles will carry RAW "
                "decoder hydrogens", RuntimeWarning)

    @classmethod
    def from_run(cls, modelparams: str, fold_dir: str, sparse: bool = False,
                 device: Union[str, torch.device] = "cuda") -> "Backmapper":
        """Rebuild the model of a CV fold and load its latest checkpoint's
        parameters (``cli.run_cgvae`` writes ``modelparams.json`` and, per
        fold, ``mapping.json`` and ``ckpt/``). The atomic numbers come from
        the run's dataset, as in the JAX package."""
        from coarsegrainingvae_tpu_torch.data.proteins import load_frames
        from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
        from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager

        cfg = ExperimentConfig.load(modelparams)
        with open(os.path.join(fold_dir, "mapping.json")) as f:
            mapping = np.asarray(json.load(f), np.int64)
        z, frames, bonds = load_frames(cfg.data.dataset, 8, seed=cfg.data.seed,
                                       device=device)
        model = build_flagship_model(cfg.model, force_sparse=sparse)
        payload, _, _ = CheckpointManager(os.path.join(fold_dir, "ckpt")).read()
        model.load_state_dict(payload["params"])
        return cls(model, mapping, z, cfg, device=device, bonds=bonds, ref_xyz=frames[0])

    def _make_batch(self, cg_xyz: np.ndarray) -> CGBatch:
        """CG-only batch on the device: the CG radius graph (all directed
        pairs within cg_cutoff, receiver-sorted), no atom graph; atom
        coordinates are ``ref_xyz`` where given, else zero (generation reads
        them only for the projection's bond lengths)."""
        cg_xyz = np.asarray(cg_xyz, np.float32)
        if cg_xyz.ndim == 2:
            cg_xyz = cg_xyz[None]
        b = cg_xyz.shape[0]
        n, m = self.n_atoms, self.n_cgs
        dev = self.device
        cg_nbrs, cg_nbr_mask = radius_graph_frames(
            cg_xyz, self.cfg.model.cg_cutoff, max_edges=max(m * (m - 1), 1), directed=True)

        def tile(a: np.ndarray) -> torch.Tensor:
            return torch.as_tensor(a, device=dev).expand((b,) + a.shape)

        def put(a: np.ndarray, dtype=torch.long) -> torch.Tensor:
            return torch.as_tensor(np.asarray(a), dtype=dtype, device=dev)

        if self.bonds is not None and len(self.bonds):
            bonds, bond_mask = tile(self.bonds), torch.ones(
                (b, self.bonds.shape[0]), dtype=torch.bool, device=dev)
        else:
            bonds = torch.zeros((b, 1, 2), dtype=torch.long, device=dev)
            bond_mask = torch.zeros((b, 1), dtype=torch.bool, device=dev)
        xyz = (tile(self.ref_xyz) if self.ref_xyz is not None
               else torch.zeros((b, n, 3), dtype=torch.float32, device=dev))
        return CGBatch(
            z=tile(self.z),
            xyz=xyz,
            atom_mask=torch.ones((b, n), dtype=torch.bool, device=dev),
            cg_z=tile(np.arange(m, dtype=np.int64)),
            cg_xyz=torch.as_tensor(cg_xyz, device=dev),
            cg_mask=torch.ones((b, m), dtype=torch.bool, device=dev),
            mapping=tile(self.mapping),
            channel_idx=tile(self.channel_idx),
            bonds=bonds,
            bond_mask=bond_mask,
            nbrs=torch.zeros((b, 1, 2), dtype=torch.long, device=dev),
            nbr_mask=torch.zeros((b, 1), dtype=torch.bool, device=dev),
            cg_nbrs=put(cg_nbrs),
            cg_nbr_mask=put(cg_nbr_mask, torch.bool),
        )

    def backmap(self, cg_xyz: np.ndarray, n_samples: int = 1,
                seed: int = 0) -> np.ndarray:
        """Generate all-atom ensembles for CG coordinates.

        cg_xyz: (M, 3) one frame or (F, M, 3). Returns (n_samples, N, 3) for
        one frame, else (F, n_samples, N, 3). Frame k's noise comes from a
        generator on the device seeded from (seed, k).
        """
        cg_xyz = np.asarray(cg_xyz, np.float32)
        single = cg_xyz.ndim == 2
        frames = cg_xyz[None] if single else cg_xyz
        eval_proj = (self.cfg.model.h_project_eval and self.bonds is not None
                     and self.ref_xyz is not None)
        outs = []
        with torch.inference_mode():
            for k, frame in enumerate(frames):
                batch = self._make_batch(np.repeat(frame[None], n_samples, axis=0))
                xyz = self.model.generate(batch, generator=generator(self.device, seed, k))
                if eval_proj:
                    xyz = project_batch_h_bonds(xyz.reshape(-1, 3), batch)
                outs.append(xyz.reshape(n_samples, self.n_atoms, 3).cpu().numpy())
        out = np.stack(outs)
        return out[0] if single else out
