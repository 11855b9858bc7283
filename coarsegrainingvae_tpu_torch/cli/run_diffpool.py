"""DiffPoolVAE training CLI (port of ``coarsegrainingvae_tpu.cli.run_diffpool``;
scripts/run_diffpool.py of the original code).

Workflow (run_diffpool.py:258-517): load frames -> the dense padded dataset
-> optionally pretrain the learned assignment toward the Newman mapping
(``-cg_method diff``) -> train with the exponential gumbel tau schedule ->
per fold the test metrics, a prior sample dump and its validity. Per fold:
``train_log.csv``, ``test_samples.npy`` and ``params.msgpack`` (flax
msgpack in JAX's tree, as the JAX package writes it; ``convert.load_params``
reads it back); per run: ``modelparams.json`` and ``cv_stats.csv``.

    python -m coarsegrainingvae_tpu_torch.cli.run_diffpool -logdir /tmp/dp \\
        -n_cgs 4 -num_features 16 -ndata 64 -nepochs 2 --device cpu

The JAX CLI's flags and defaults, plus ``--device`` (default ``cuda``: the
run needs a card unless the caller asks for the CPU).
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np

from coarsegrainingvae_tpu_torch.config import DiffPoolConfig
from coarsegrainingvae_tpu_torch.convert import save_params
from coarsegrainingvae_tpu_torch.data.dataset import kfold_indices
from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
from coarsegrainingvae_tpu_torch.data.proteins import load_frames
from coarsegrainingvae_tpu_torch.eval.metrics import evaluate_samples
from coarsegrainingvae_tpu_torch.train.diffpool_trainer import DiffPoolTrainer
from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables
from coarsegrainingvae_tpu_torch.utils.logging import CSVLogger, annotate_job


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-logdir", type=str, default="./run_diffpool")
    p.add_argument("-dataset", type=str, default="dipeptide")
    p.add_argument("-n_cgs", type=int, default=3)
    p.add_argument("-num_features", type=int, default=512)
    p.add_argument("-n_rbf", type=int, default=7)
    p.add_argument("-cutoff", type=float, default=8.0)
    p.add_argument("-cg_cutoff", type=float, default=30.0)
    p.add_argument("-nconv_pool", type=int, default=1)
    p.add_argument("-enc_nconv", type=int, default=2)
    p.add_argument("-dec_nconv", type=int, default=3)
    p.add_argument("-activation", type=str, default="swish")
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-nepochs", type=int, default=2)
    p.add_argument("-ndata", type=int, default=200)
    p.add_argument("-lr", type=float, default=1e-4)
    p.add_argument("-beta", type=float, default=0.05)
    p.add_argument("-gamma", type=float, default=0.0)
    p.add_argument("-zeta", type=float, default=0.0,
                   help="excluded-volume hinge weight (repo extension; 0 = reference loss)")
    p.add_argument("-steric_margin", type=float, default=0.3)
    p.add_argument("--steric_data_margin", action="store_true",
                   help="per-pair hinge thresholds from the training ensemble's closest "
                        "approaches (see run_cgvae)")
    p.add_argument("-zeta_warmup", type=int, default=0,
                   help="linear steric-weight ramp over the first N steps")
    p.add_argument("--graph_grad", action="store_true", default=False,
                   help="make gamma*graph gradient-active (the reference only tracks it, "
                        "run_diffpool.py:207-210)")
    p.add_argument("-graph_warmup", type=int, default=0,
                   help="with --graph_grad: linear ramp of the gradient-active graph weight "
                        "over the first N steps (the tracked loss keeps the full gamma*graph)")
    p.add_argument("--h_project", action="store_true", default=False,
                   help="snap each hydrogen onto its covalent bond length along the decoded "
                        "direction (repo extension; default off = reference)")
    p.add_argument("-tau_0", type=float, default=2.0)
    p.add_argument("-tau_min", type=float, default=0.3)
    p.add_argument("-tau_rate", type=float, default=0.004)
    p.add_argument("-n_pretrain", type=int, default=0)
    p.add_argument("-nsplits", type=int, default=2)
    p.add_argument("-patience", type=int, default=20)
    p.add_argument("-lr_patience", type=int, default=10,
                   help="plateau-controller patience (epochs)")
    p.add_argument("-lr_factor", type=float, default=0.6)
    p.add_argument("-min_lr", type=float, default=1e-8)
    p.add_argument("-seed", type=int, default=123)
    p.add_argument("-cg_method", type=str, default="diff", choices=["diff", "newman"])
    p.add_argument("--det", action="store_true", default=False)
    p.add_argument("--sample_hard", action="store_true", default=False,
                   help="generative sampling commits to the argmax assignment (noise-free "
                        "tau->0 limit) instead of re-drawing gumbel noise per sample")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the card)")
    return p


def config_from_args(a: argparse.Namespace, n_atoms: int) -> DiffPoolConfig:
    return DiffPoolConfig(
        n_atoms=n_atoms, n_cgs=a.n_cgs, feat_dim=a.num_features, n_rbf=a.n_rbf,
        atom_cutoff=a.cutoff, cg_cutoff=a.cg_cutoff, pool_nconv=a.nconv_pool,
        enc_nconv=a.enc_nconv, dec_nconv=a.dec_nconv, activation=a.activation, det=a.det,
        tau_0=a.tau_0, tau_min=a.tau_min, tau_rate=a.tau_rate,
        trainable_map=(a.cg_method == "diff"),
    )


def main(argv=None):
    a = build_parser().parse_args(argv)
    logdir = annotate_job(f"diffpool_{a.cg_method}_ndata{a.ndata}", a.logdir, a.n_cgs)
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "modelparams.json"), "w") as f:
        json.dump(vars(a), f, indent=2)

    z, frames, bonds = load_frames(a.dataset, a.ndata, seed=a.seed, device=a.device)
    n_atoms = z.shape[0]
    cfg = config_from_args(a, n_atoms)
    target = newman_mapping(bonds, n_atoms, a.n_cgs, seed=a.seed)
    assign_idx = tuple(int(x) for x in target) if a.cg_method == "newman" else None

    all_rows = []
    for fold, (train_idx, test_idx) in enumerate(kfold_indices(frames.shape[0], a.nsplits,
                                                               a.seed)):
        split_dir = os.path.join(logdir, f"fold{fold}")
        os.makedirs(split_dir, exist_ok=True)
        ds_train = build_diffpool_dataset(frames[train_idx], z, bonds, rotate=True, seed=a.seed)
        ds_test = build_diffpool_dataset(frames[test_idx], z, bonds)
        n_val = max(int(len(ds_train) * 0.1), 1)
        ds_val, ds_tr = (ds_train.subset(np.arange(n_val)),
                         ds_train.subset(np.arange(n_val, len(ds_train))))

        steric = None
        if a.zeta > 0.0:
            steric = build_steric_tables(
                z, bonds, margin=a.steric_margin,
                frames=frames[train_idx] if a.steric_data_margin else None)
        trainer = DiffPoolTrainer(
            cfg, beta=a.beta, gamma=a.gamma, lr=a.lr, assign_idx=assign_idx, seed=a.seed,
            zeta=a.zeta, steric_tables=steric, graph_grad=a.graph_grad,
            zeta_warmup=a.zeta_warmup, graph_warmup=a.graph_warmup, h_project=a.h_project,
            device=a.device)
        state = trainer.init_state()
        if a.n_pretrain > 0 and a.cg_method == "diff":
            state, ploss = trainer.pretrain(state, ds_tr, target, a.n_pretrain, a.batch_size)
            print(f"fold {fold}: pretrain loss {ploss:.5f}")

        logger = CSVLogger(os.path.join(split_dir, "train_log.csv"))
        state, hist = trainer.fit(state, ds_tr, ds_val, a.nepochs, a.batch_size,
                                  patience=a.patience, lr_patience=a.lr_patience,
                                  lr_factor=a.lr_factor, min_lr=a.min_lr, log_fn=logger.log)
        if not hist:
            continue

        # test-set metrics and a prior sample dump
        _, test_m = trainer.run_epoch(state, ds_test, (a.seed + 99,), a.batch_size,
                                      train=False)
        xs = trainer.sample(ds_test.batch(np.arange(min(8, len(ds_test)))), a.seed,
                            a.sample_hard)
        samples = xs.cpu().numpy()
        np.save(os.path.join(split_dir, "test_samples.npy"), samples)
        # the final parameters as flax msgpack in JAX's tree (run_diffpool.py:173-177)
        save_params(os.path.join(split_dir, "params.msgpack"), state.params, cfg)

        # sample quality against the covalent bond graph (run_diffpool.py:46-113)
        ref_xyz = np.asarray(ds_test.xyz[0])
        ref_xyz = ref_xyz - ref_xyz.mean(0, keepdims=True)
        q = evaluate_samples(ref_xyz, samples, z)
        row = {
            "fold": fold,
            **{f"test_{k}": v for k, v in test_m.items()},
            "sample_valid_ratio": q["valid_ratio"],
            "sample_allatom_valid_ratio": q["valid_allatom_ratio"],
            "sample_ged": q["graph_val_ratio"],
            "sample_allatom_ged": q["graph_allatom_val_ratio"],
        }
        all_rows.append(row)
        CSVLogger(os.path.join(logdir, "cv_stats.csv")).log(row)
    return all_rows


if __name__ == "__main__":
    main()
