"""Baseline-zoo training CLI (port of ``coarsegrainingvae_tpu.cli.run_baseline``;
scripts/run_baseline.py of the original code).

K-fold CV over the model zoo (run_baseline.py:285-302) with a fixed CG
mapping; loss = recon + gamma * the graph-loss edge lengths' MSE
(run_baseline.py:146-149). Per fold ``train_log.csv``; per run
``modelparams.json`` and ``cv_stats.csv`` (``test_recon_rmsd`` and the
test metrics).

    python -m coarsegrainingvae_tpu_torch.cli.run_baseline -logdir /tmp/bl \\
        -model equimlp -ndata 64 -nepochs 2 --device cpu

The JAX CLI's flags and defaults, plus ``--device`` (default ``cuda``).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.dataset import kfold_indices
from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
from coarsegrainingvae_tpu_torch.data.mappings import get_mapping
from coarsegrainingvae_tpu_torch.data.proteins import load_frames
from coarsegrainingvae_tpu_torch.data.topology import (
    channel_index_from_mapping,
    max_atoms_per_bead,
)
from coarsegrainingvae_tpu_torch.models.baseline import BASELINE_ZOO, build_baseline
from coarsegrainingvae_tpu_torch.train.baseline_trainer import BaselineTrainer
from coarsegrainingvae_tpu_torch.utils.logging import CSVLogger, annotate_job


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-logdir", type=str, default="./run_baseline")
    p.add_argument("-dataset", type=str, default="dipeptide")
    p.add_argument("-model", type=str, default="equilinear", choices=list(BASELINE_ZOO))
    p.add_argument("-n_cgs", type=int, default=3)
    p.add_argument("-cg_method", type=str, default="newman")
    p.add_argument("-knn", type=int, default=3)
    p.add_argument("-width", type=int, default=1)
    p.add_argument("-depth", type=int, default=1)
    p.add_argument("-activation", type=str, default="ReLU")
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-nepochs", type=int, default=5)
    p.add_argument("-ndata", type=int, default=200)
    p.add_argument("-lr", type=float, default=1e-3)
    p.add_argument("-gamma", type=float, default=0.0)
    p.add_argument("-nsplits", type=int, default=2)
    p.add_argument("-seed", type=int, default=123)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the card)")
    return p


def model_kwargs(a: argparse.Namespace, mapping: np.ndarray) -> dict:
    """The zoo entry's keyword arguments from the CLI's flags."""
    kwargs = {}
    if a.model in ("equimlp", "equimlp2", "setequimlp"):
        kwargs = dict(knn=a.knn, width=a.width, depth=a.depth, activation=a.activation)
    elif a.model == "mlp":
        kwargs = dict(width=a.width, depth=a.depth, activation=a.activation)
    elif a.model in ("edgesetmlp", "equilinear"):
        kwargs = dict(knn=a.knn)
    if a.model == "setequimlp":
        kwargs.update(channel_idx=channel_index_from_mapping(mapping),
                      n_channels=max_atoms_per_bead(mapping))
    return kwargs


def main(argv=None):
    a = build_parser().parse_args(argv)
    logdir = annotate_job(f"baseline_{a.model}_ndata{a.ndata}", a.logdir, a.n_cgs)
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "modelparams.json"), "w") as f:
        json.dump(vars(a), f, indent=2)

    z, frames, bonds = load_frames(a.dataset, a.ndata, seed=a.seed, device=a.device)
    n_atoms = z.shape[0]
    mapping = get_mapping(a.cg_method, a.n_cgs, n_atoms, bonds=bonds, frames=frames,
                          seed=a.seed, device=a.device)
    kwargs = model_kwargs(a, mapping)

    rows = []
    for fold, (train_idx, test_idx) in enumerate(kfold_indices(frames.shape[0], a.nsplits,
                                                               a.seed)):
        split_dir = os.path.join(logdir, f"fold{fold}")
        os.makedirs(split_dir, exist_ok=True)
        ds_train = build_diffpool_dataset(frames[train_idx], z, bonds)
        ds_test = build_diffpool_dataset(frames[test_idx], z, bonds)
        n_val = max(int(len(ds_train) * 0.1), 1)
        ds_val, ds_tr = (ds_train.subset(np.arange(n_val)),
                         ds_train.subset(np.arange(n_val, len(ds_train))))

        model = build_baseline(a.model, a.n_cgs, n_atoms, mapping,
                               generator=torch.Generator().manual_seed(a.seed), **kwargs)
        trainer = BaselineTrainer(model, gamma=a.gamma, lr=a.lr, seed=a.seed, device=a.device)
        state = trainer.init_state()
        logger = CSVLogger(os.path.join(split_dir, "train_log.csv"))
        state, hist = trainer.fit(state, ds_tr, ds_val, a.nepochs, a.batch_size,
                                  log_fn=logger.log)
        if not hist:
            continue
        _, test_m = trainer.run_epoch(state, ds_test, a.batch_size, train=False)
        row = {
            "fold": fold,
            "test_recon_rmsd": float(np.sqrt(test_m["recon"])),
            **{f"test_{k}": v for k, v in test_m.items()},
        }
        rows.append(row)
        CSVLogger(os.path.join(logdir, "cv_stats.csv")).log(row)
    return rows


if __name__ == "__main__":
    main()
