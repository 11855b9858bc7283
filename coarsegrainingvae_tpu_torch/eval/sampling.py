"""Prior-conditioned ensemble sampling and test-set reconstruction (port of
``coarsegrainingvae_tpu.eval.sampling``).

The ensemble is the batch axis: one frame's CG geometry is tiled n_sample
times into one batch and a single ``Trainer.generate`` call decodes the
whole ensemble (the original code loops over n_ensemble decoder calls at
batch 1, scripts/sampling.py:252-311). The trainer holds its model's
parameters, so no params argument is passed. Frame k's noise comes from a
generator on the trainer's device seeded from (seed, k), the stand-in for
the JAX package's ``fold_in(rng, k)``; the metrics are host numpy.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.eval.metrics import evaluate_samples
from coarsegrainingvae_tpu_torch.utils.rng import generator


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def tile_frame(ds: CGDatasetArrays, frame: int, n: int) -> CGBatch:
    """Replicate one frame n times along the batch axis."""
    return ds.batch(np.full((n,), frame, dtype=np.int64))


def reflect_batch(batch: CGBatch) -> CGBatch:
    """Reflect coordinates across the x-z plane (the --reflectiontest probe,
    utils.py:216-219 / sampling.py:258-261)."""
    flip = torch.tensor([1.0, -1.0, 1.0])
    return dataclasses.replace(batch, xyz=batch.xyz * flip.to(batch.xyz.device),
                               cg_xyz=batch.cg_xyz * flip.to(batch.cg_xyz.device))


def sample_ensemble(
    trainer,
    ds: CGDatasetArrays,
    frames: np.ndarray,
    n_sample: int,
    seed: int,
    graph_eval: bool = True,
    reflection: bool = False,
) -> Dict[str, object]:
    """Generate n_sample structures per selected frame, and quality metrics
    (sample_ensemble, sampling.py:335-399)."""
    n_atoms = ds.n_atoms
    z = ds.z
    device = trainer.device

    sample_xyzs: List[np.ndarray] = []
    data_xyzs: List[np.ndarray] = []
    recon_xyzs: List[np.ndarray] = []
    cg_xyzs: List[np.ndarray] = []
    stats: Dict[str, list] = {
        "all_rmsds": [], "heavy_rmsds": [], "valid_ratio": [],
        "valid_allatom_ratio": [], "graph_val_ratio": [],
        "graph_allatom_val_ratio": [],
    }

    for k, f in enumerate(np.asarray(frames)):
        batch = tile_frame(ds, int(f), n_sample)
        if reflection:
            batch = reflect_batch(batch)
        gen = _host(trainer.generate(batch, generator(device, seed, k)))
        gen = gen.reshape(n_sample, n_atoms, 3)
        ref = _host(batch.xyz)[0]

        recon = trainer.reconstruct(ds.batch(np.array([int(f)])),
                                    generator(device, seed, 10_000 + k))
        recon = _host(recon).reshape(n_atoms, 3)

        sample_xyzs.append(gen)
        data_xyzs.append(ref)
        recon_xyzs.append(recon)
        cg_xyzs.append(_host(batch.cg_xyz)[0])

        if graph_eval:
            q = evaluate_samples(ref, gen, z)
            for key in stats:
                v = q[key]
                if v is not None:
                    stats[key].append(v)

    out: Dict[str, object] = {
        "sample_xyzs": np.stack(sample_xyzs),
        "data_xyzs": np.stack(data_xyzs),
        "recon_xyzs": np.stack(recon_xyzs),
        "cg_xyzs": np.stack(cg_xyzs),
    }
    if graph_eval:
        def mean(key):
            return float(np.mean(stats[key])) if stats[key] else 0.0

        out["sample_valid"] = mean("valid_ratio")
        out["sample_allatom_valid"] = mean("valid_allatom_ratio")
        out["sample_graph_val_ratio"] = mean("graph_val_ratio")
        out["sample_graph_allatom_val_ratio"] = mean("graph_allatom_val_ratio")
        out["all_rmsds"] = np.concatenate(stats["all_rmsds"]) if stats["all_rmsds"] else None
        out["heavy_rmsds"] = (np.concatenate(stats["heavy_rmsds"])
                              if stats["heavy_rmsds"] else None)
    return out


def reconstruct_all(
    trainer,
    ds: CGDatasetArrays,
    seed: int,
    batch_size: int = 32,
    graph_eval: bool = True,
    reflection: bool = False,
) -> Dict[str, object]:
    """Reconstruct every frame, with per-structure validity/GED
    (get_all_true_reconstructed_structures, scripts/utils.py:193-268). The
    last batch is padded by wrap-around to ``batch_size``; the batch at
    offset lo draws from a generator seeded from (seed, lo)."""
    n = len(ds)
    n_atoms = ds.n_atoms
    recons = np.empty((n, n_atoms, 3), np.float32)
    trues = np.empty((n, n_atoms, 3), np.float32)
    cgs = np.empty((n, ds.n_cgs, 3), np.float32)

    order = np.arange(n)
    for lo in range(0, n, batch_size):
        idx = order[lo : lo + batch_size]
        pad = batch_size - idx.shape[0]
        if pad:
            idx = np.concatenate([idx, order[:pad]])
        batch = ds.batch(idx)
        if reflection:
            batch = reflect_batch(batch)
        recon = trainer.reconstruct(batch, generator(trainer.device, seed, lo))
        recon = _host(recon).reshape(batch_size, n_atoms, 3)
        take = batch_size - pad
        recons[lo : lo + take] = recon[:take]
        trues[lo : lo + take] = _host(batch.xyz)[:take]
        cgs[lo : lo + take] = _host(batch.cg_xyz)[:take]

    out: Dict[str, object] = {"true_xyzs": trues, "recon_xyzs": recons, "cg_xyzs": cgs}
    if graph_eval:
        per = [evaluate_samples(trues[i], recons[i : i + 1], ds.z) for i in range(n)]
        out["all_valid_ratio"] = float(np.mean([p["valid_allatom_ratio"] for p in per]))
        out["heavy_valid_ratio"] = float(np.mean([p["valid_ratio"] for p in per]))
        out["all_ged"] = float(np.mean([p["graph_allatom_val_ratio"] for p in per]))
        out["heavy_ged"] = float(np.mean([p["graph_val_ratio"] for p in per]))
    # unaligned recon RMSD over the whole set (run_ala.py:338-352)
    d2 = ((recons - trues) ** 2).sum(-1)
    out["all_atom_rmsd"] = float(np.sqrt(d2.mean()))
    heavy = ds.z != 1
    out["heavy_atom_rmsd"] = float(np.sqrt(d2[:, heavy].mean()))
    # robust per-frame statistics beside the pooled mean: one pathological
    # frame can dominate the mean, so also the median and p99 per frame
    frame_all = np.sqrt(d2.mean(axis=1))
    frame_heavy = np.sqrt(d2[:, heavy].mean(axis=1))
    out["all_atom_rmsd_median"] = float(np.median(frame_all))
    out["all_atom_rmsd_p99"] = float(np.percentile(frame_all, 99))
    out["heavy_atom_rmsd_median"] = float(np.median(frame_heavy))
    out["heavy_atom_rmsd_p99"] = float(np.percentile(frame_heavy, 99))
    return out
