"""Reload a finished fold and re-evaluate it (port of
``coarsegrainingvae_tpu.cli.postanalysis``): reconstruct the dataset,
sample ensembles and project true vs generated structures into a shared
TICA space (postanalysis.py:25-146 of the original code).

    python -m coarsegrainingvae_tpu_torch.cli.postanalysis -logdir <run>/fold0 \\
        -modelparams <run>/modelparams.json [--device cpu]

It reads folds that ``coarsegrainingvae_tpu_torch.cli.run_cgvae`` wrote
(``torch.save`` checkpoints, not orbax).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from coarsegrainingvae_tpu_torch.config import ExperimentConfig
from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
from coarsegrainingvae_tpu_torch.data.proteins import load_frames
from coarsegrainingvae_tpu_torch.eval.analysis import pairwise_distance_features, tica
from coarsegrainingvae_tpu_torch.eval.sampling import reconstruct_all, sample_ensemble
from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.trainer import Trainer
from coarsegrainingvae_tpu_torch.utils.rng import fold_in


def load_run(modelparams: str, fold_dir: str, device="cuda"):
    """(cfg, trainer, state, mapping, dataset) of a finished fold, the
    latest checkpoint restored on ``device``."""
    cfg = ExperimentConfig.load(modelparams)
    with open(os.path.join(fold_dir, "mapping.json")) as f:
        mapping = np.asarray(json.load(f), np.int32)
    trainer = Trainer(build_flagship_model(cfg.model), cfg, device=device)

    z, frames, bonds = load_frames(cfg.data.dataset, cfg.data.ndata,
                                   seed=cfg.data.seed, device=device)
    ds = build_dataset(mapping, frames, cfg.model.atom_cutoff, cfg.model.cg_cutoff,
                       z, bonds, order=cfg.data.edgeorder, rotate=False,
                       seed=cfg.data.seed)
    template = trainer.init_state(ds.batch(np.arange(min(cfg.data.batch_size, len(ds)))))
    state, _, _ = CheckpointManager(os.path.join(fold_dir, "ckpt")).restore(template)
    return cfg, trainer, state, mapping, ds


def reevaluate(modelparams: str, fold_dir: str, graph_eval: bool = True,
               n_ensemble: int = 8, nevals: int = 16, device="cuda",
               keep_xyz: bool = False) -> dict:
    cfg, trainer, _, _, ds = load_run(modelparams, fold_dir, device=device)
    seed = cfg.data.seed + 1234
    recon = reconstruct_all(trainer, ds, seed, batch_size=cfg.data.batch_size,
                            graph_eval=graph_eval)
    frames_idx = np.linspace(0, len(ds) - 1, min(nevals, len(ds))).astype(int)
    samples = sample_ensemble(trainer, ds, frames_idx, n_ensemble, fold_in(seed, 1),
                              graph_eval=graph_eval)

    # shared-TICA projection of true vs generated (postanalysis.py:25-68)
    true_feats = pairwise_distance_features(recon["true_xyzs"])
    gen_feats = pairwise_distance_features(samples["sample_xyzs"].reshape(-1, ds.n_atoms, 3))
    lag = max(min(len(true_feats) // 10, 50), 1)
    _, comps = tica(true_feats, lag=lag, dim=2)
    mean = true_feats.mean(0)
    out = {
        "all_atom_rmsd": recon["all_atom_rmsd"],
        "heavy_atom_rmsd": recon["heavy_atom_rmsd"],
        "tica_true": ((true_feats - mean) @ comps).tolist(),
        "tica_gen": ((gen_feats - mean) @ comps).tolist(),
    }
    if graph_eval:
        out.update({k: recon[k] for k in
                    ("all_valid_ratio", "heavy_valid_ratio", "all_ged", "heavy_ged")})
    if keep_xyz:        # the true and generated frames, (T, N, 3) numpy
        out.update(true_xyzs=np.asarray(recon["true_xyzs"]),
                   sample_xyzs=np.asarray(samples["sample_xyzs"]).reshape(-1, ds.n_atoms, 3))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-modelparams", type=str, required=True)
    p.add_argument("-logdir", type=str, required=True,
                   help="fold directory containing mapping.json + ckpt/")
    p.add_argument("-out", type=str, default="")
    p.add_argument("--no_graph_eval", action="store_true")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device (default: the card; cpu for the CPU)")
    a = p.parse_args(argv)
    res = reevaluate(a.modelparams, a.logdir, graph_eval=not a.no_graph_eval,
                     device=a.device)
    summary = {k: v for k, v in res.items() if not k.startswith("tica")}
    print(json.dumps(summary, indent=2))
    if a.out:
        with open(a.out, "w") as f:
            json.dump(res, f)
    return res


if __name__ == "__main__":
    main()
