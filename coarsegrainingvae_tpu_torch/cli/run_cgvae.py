"""K-fold cross-validated CGVAE training CLI (port of
``coarsegrainingvae_tpu.cli.run_cgvae``).

Per fold: build the CG mapping (with the degeneracy retry of run_ala.py:
170-174), preprocess to fixed-shape arrays, train with ``Trainer.fit``
(LOWESS-plateau LR, early stop, NaN abort, checkpoints), then reconstruct
the test split, sample prior ensembles and append one row to the
``cv_stats.csv`` contract. Artifacts per fold: ``mapping.json``, ``ckpt/``,
``train_log.csv``, ``test_recon.xyz``, ``test_samples.xyz``,
``rotate_{ensemble,data,recon,cg}.xyz`` (``FAILED.txt`` on a NaN run), and
the port's own ``tracing.json``, ``utils.tracing.snapshot()`` once ``fit``
returns: the fold's set-up spans and the last epoch's phase means of the
train step; per run: ``modelparams.json``, ``cv_stats.csv``,
``cv_stats_summary.json``.

Usage:  python -m coarsegrainingvae_tpu_torch.cli.run_cgvae -dataset dipeptide \\
            -n_cgs 3 -ndata 2000 -nepochs 50 ... [--device cpu]

The same flags and defaults as the JAX CLI, plus ``--device`` (default
``cuda``: the run needs a card unless the caller asks for the CPU).
``--message_impl``/``--pseudo_impl`` are stored in ``modelparams.json`` and
have no effect: the port's dense model always runs its CUDA kernels.
``-cg_method cgae`` learns each fold's mapping on ``--device``. ``--sparse``
and the pseudo2/en/inv decoders train the sparse ``CGequiVAE``; ``-zeta``
(with ``-zeta_warmup`` and ``--steric_data_margin``) builds each fold's
excluded-volume tables before its trainer; ``--h_project`` and
``--h_project_eval`` project the hydrogens, as in the JAX CLI.

Under ``torchrun`` (WORLD_SIZE set) the run trains data-parallel over every
rank, as the JAX CLI trains over every local chip:

    torchrun --nproc_per_node 4 -m coarsegrainingvae_tpu_torch.cli.run_cgvae ...

The process group is NCCL for ``--device cuda`` (rank r on cuda:LOCAL_RANK)
and gloo for ``--device cpu``. Rank 0 loads the frames and builds each
fold's mapping and broadcasts them, so every rank builds the same datasets;
``fit`` trains with data parallelism; ``reconstruct_all`` and
``sample_ensemble`` run replicated on every rank; only rank 0 writes files,
and the ranks meet at a barrier at the end of each fold. Without
``torchrun`` nothing of this happens.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from coarsegrainingvae_tpu_torch.config import (
    DataConfig,
    ExperimentConfig,
    ModelConfig,
    TrainConfig,
)
from coarsegrainingvae_tpu_torch.data.dataset import build_dataset, kfold_indices
from coarsegrainingvae_tpu_torch.data.mappings import get_mapping
from coarsegrainingvae_tpu_torch.data.proteins import load_frames
from coarsegrainingvae_tpu_torch.eval.analysis import get_cv_stats
from coarsegrainingvae_tpu_torch.eval.sampling import reconstruct_all, sample_ensemble
from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE, build_flagship_model
from coarsegrainingvae_tpu_torch.parallel.mesh import init_distributed, local_device
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables
from coarsegrainingvae_tpu_torch.train.trainer import Trainer
from coarsegrainingvae_tpu_torch.utils import tracing
from coarsegrainingvae_tpu_torch.utils.logging import CSVLogger, annotate_job
from coarsegrainingvae_tpu_torch.utils.rng import fold_in
from coarsegrainingvae_tpu_torch.utils.visualization import save_grid_snapshots
from coarsegrainingvae_tpu_torch.utils.xyz import write_xyz

CV_STAT_FIELDS = [
    "fold", "epoch", "train_recon_rmsd", "test_all_recon_rmsd",
    "test_heavy_recon_rmsd",
    "test_all_recon_rmsd_median", "test_all_recon_rmsd_p99",
    "test_heavy_recon_rmsd_median", "test_heavy_recon_rmsd_p99",
    "recon_all_ged", "recon_heavy_ged",
    "recon_all_valid_ratio", "recon_heavy_valid_ratio",
    "sample_all_rmsd", "sample_heavy_rmsd", "sample_all_ged",
    "sample_heavy_ged", "sample_all_valid_ratio", "sample_heavy_valid_ratio",
    "KL", "graph", "wall_s",
]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-logdir", type=str, default="./run")
    p.add_argument("-n_cgs", type=int, default=3)
    p.add_argument("-lr", type=float, default=2e-4)
    p.add_argument("-dataset", type=str, default="dipeptide")
    p.add_argument("-n_basis", type=int, default=512)
    p.add_argument("-n_rbf", type=int, default=10)
    p.add_argument("-activation", type=str, default="swish")
    p.add_argument("-cg_method", type=str, default="newman")
    p.add_argument("-atom_cutoff", type=float, default=8.5)
    p.add_argument("-cg_cutoff", type=float, default=9.5)
    p.add_argument("-enc_nconv", type=int, default=4)
    p.add_argument("-dec_nconv", type=int, default=4)
    p.add_argument("-batch_size", type=int, default=32)
    p.add_argument("-nepochs", type=int, default=2)
    p.add_argument("-ndata", type=int, default=200)
    p.add_argument("-n_ensemble", type=int, default=16)
    p.add_argument("-nevals", type=int, default=36)
    p.add_argument("-edgeorder", type=int, default=2)
    p.add_argument("-auxcutoff", type=float, default=0.0)
    p.add_argument("-beta", type=float, default=0.001)
    p.add_argument("-gamma", type=float, default=0.01)
    p.add_argument("-loss_skip_factor", type=float, default=200.0,
                   help="skip-batch guard threshold: skip the update when "
                        "loss >= gamma*THIS (the original code uses 200). The "
                        "graph loss is extensive in system size, so at spike "
                        "scale the default rejects every update -- raise it "
                        "(the NaN/inf gradient guards stay active regardless)")
    p.add_argument("-zeta", type=float, default=0.0,
                   help="excluded-volume hinge weight on nonbonded pair "
                        "distances (0 = the original loss)")
    p.add_argument("-steric_margin", type=float, default=0.3,
                   help="safety margin (A) above the covalent-validity "
                        "cutoff for the -zeta hinge")
    p.add_argument("--steric_data_margin", action="store_true",
                   help="per-pair hinge thresholds from the training "
                        "ensemble's own closest approaches")
    p.add_argument("-h_bond_weight", type=float, default=1.0,
                   help="upweight X-H bonded-distance terms in the graph "
                        "loss (1.0 = the original loss)")
    p.add_argument("-zeta_warmup", type=int, default=0,
                   help="linear steric-weight ramp over the first N steps")
    p.add_argument("-eta_h", type=float, default=0.0,
                   help="additive bonded-distance MSE over H-touching "
                        "graph edges (0 = the original loss)")
    p.add_argument("-nsplits", type=int, default=5)
    p.add_argument("-patience", type=int, default=15)
    p.add_argument("-factor", type=float, default=0.6)
    p.add_argument("-lr_patience", type=int, default=2)
    p.add_argument("-min_lr", type=float, default=5e-8)
    p.add_argument("--adam_dtype", type=str, default=None,
                   help="Adam moment storage (float32|bfloat16); default "
                        "from TrainConfig")
    p.add_argument("-mapshuffle", type=float, default=0.0)
    p.add_argument("-site_index", type=str, default=None,
                   help="explicit CG site atom indices for minimal/alpha "
                        "mappings: comma-separated ints (e.g. '1,11,21', "
                        "one per bead) or a path to a .npy int array")
    p.add_argument("-seed", type=int, default=123)
    p.add_argument("-checkpoint_every", type=int, default=0)
    p.add_argument("-max_folds", type=int, default=0,
                   help="run only K CV folds starting at -fold_offset "
                        "(0 = all); the fold split itself still uses -nsplits")
    p.add_argument("-fold_offset", type=int, default=0,
                   help="skip CV folds below this index; splits are "
                        "seed-deterministic, so fold k here is fold k of "
                        "any same-seed run")
    p.add_argument("--dec_type", type=str, default="cross",
                   choices=["pseudo", "pseudo2", "cross", "painn", "en", "inv"])
    p.add_argument("--graph_eval", action="store_true", default=False)
    p.add_argument("--det", action="store_true", default=False)
    p.add_argument("--invariantdec", action="store_true", default=False)
    p.add_argument("--reflectiontest", action="store_true", default=False)
    p.add_argument("--resume", action="store_true", default=False)
    p.add_argument("--message_impl", type=str, default="einsum",
                   choices=["einsum", "qmat"],
                   help="the JAX package's message formulation; stored, no "
                        "effect in the port")
    p.add_argument("--pseudo_impl", type=str, default="stacked",
                   choices=["stacked", "einsum", "pallas"],
                   help="the JAX package's pseudo formulation; stored, no "
                        "effect in the port")
    p.add_argument("--sparse", action="store_true", default=False,
                   help="use the segment-sum formulation (CGequiVAE) instead "
                        "of the dense-regime flagship")
    p.add_argument("--degree_norm", action="store_true", default=False,
                   help="rsqrt(degree) message scaling for high-degree graphs")
    p.add_argument("--h_project", action="store_true", default=False,
                   help="snap each hydrogen onto its covalent bond length "
                        "along the decoded direction")
    p.add_argument("--h_project_eval", action="store_true", default=False,
                   help="eval-only h_project: the original training dynamics, "
                        "projected reconstruct/generate outputs")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the card; pass "
                        "cpu to run the kernels' plain versions on the CPU)")
    return p


def parse_site_index(spec):
    """'1,11,21' or a .npy path -> tuple of atom indices (None passes)."""
    if spec is None:
        return None
    if str(spec).endswith(".npy"):
        return tuple(int(v) for v in np.load(spec).reshape(-1))
    return tuple(int(v) for v in str(spec).split(","))


def params_to_config(a: argparse.Namespace) -> ExperimentConfig:
    dec_type = "inv" if a.invariantdec else a.dec_type
    return ExperimentConfig(
        model=ModelConfig(
            n_cgs=a.n_cgs, n_basis=a.n_basis, n_rbf=a.n_rbf,
            atom_cutoff=a.atom_cutoff, cg_cutoff=a.cg_cutoff,
            enc_nconv=a.enc_nconv, dec_nconv=a.dec_nconv,
            activation=a.activation, dec_type=dec_type,
            breaksym=(a.n_cgs == 3),  # run_ala.py:192-197
            det=a.det, sparse=a.sparse, degree_norm=a.degree_norm,
            h_project=a.h_project, h_project_eval=a.h_project_eval,
            message_impl=a.message_impl, pseudo_impl=a.pseudo_impl,
        ),
        data=DataConfig(
            dataset=a.dataset, ndata=a.ndata, batch_size=a.batch_size,
            cg_method=a.cg_method, edgeorder=a.edgeorder, nsplits=a.nsplits,
            mapshuffle=a.mapshuffle, seed=a.seed, auxcutoff=a.auxcutoff,
            site_index=parse_site_index(a.site_index),
        ),
        train=TrainConfig(
            nepochs=a.nepochs, lr=a.lr, beta=a.beta, gamma=a.gamma,
            zeta=a.zeta, steric_margin=a.steric_margin,
            loss_skip_factor=a.loss_skip_factor,
            steric_data_margin=a.steric_data_margin,
            h_bond_weight=a.h_bond_weight,
            zeta_warmup=a.zeta_warmup, eta_h=a.eta_h,
            patience=a.patience, lr_factor=a.factor,
            lr_patience=a.lr_patience, min_lr=a.min_lr,
            checkpoint_every=a.checkpoint_every,
            **({"adam_moment_dtype": a.adam_dtype} if a.adam_dtype else {}),
        ),
        logdir=a.logdir,
    )


def build_fold_mapping(cfg: ExperimentConfig, z, frames, bonds, seed: int, device="cuda"):
    """Mapping with the degeneracy retry loop (run_ala.py:170-174); cgae
    learns it on ``device``."""
    n_atoms = z.shape[0]
    for attempt in range(20):
        mapping = get_mapping(
            cfg.data.cg_method, cfg.model.n_cgs, n_atoms, bonds=bonds,
            frames=frames, mapshuffle=cfg.data.mapshuffle,
            site_index=(None if cfg.data.site_index is None
                        else np.asarray(cfg.data.site_index, np.int64)),
            seed=seed + attempt, z=z, device=device,
        )
        if np.unique(mapping).size == cfg.model.n_cgs:
            return mapping
    raise RuntimeError("could not build a non-degenerate CG mapping")


def _from_rank0(make):
    """make() on rank 0, broadcast to every rank of the default process
    group; make() alone without one."""
    if not dist.is_initialized():
        return make()
    box = [make() if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def fold_datasets(cfg: ExperimentConfig, mapping, z, frames, bonds, train_idx, test_idx):
    """(train, validation, test) datasets of one fold: the first val_frac
    of the (shuffled) training frames validate, the test set is not
    rotated and is padded to the training set's edge counts."""
    aux = cfg.data.auxcutoff if cfg.data.auxcutoff > 0 else None
    ds_train_full = build_dataset(
        mapping, frames[train_idx], cfg.model.atom_cutoff,
        cfg.model.cg_cutoff, z, bonds, order=cfg.data.edgeorder,
        seed=cfg.data.seed, aux_cutoff=aux,
    )
    ds_test = build_dataset(
        mapping, frames[test_idx], cfg.model.atom_cutoff,
        cfg.model.cg_cutoff, z, bonds, order=cfg.data.edgeorder,
        seed=cfg.data.seed, rotate=False,
        max_atom_edges=ds_train_full.nbrs.shape[1],
        max_cg_edges=ds_train_full.cg_nbrs.shape[1],
        aux_cutoff=aux,
    )
    n_val = max(int(len(ds_train_full) * cfg.data.val_frac), 1)
    return (ds_train_full.subset(np.arange(n_val, len(ds_train_full))),
            ds_train_full.subset(np.arange(n_val)), ds_test)


def run_cv(cfg: ExperimentConfig, n_ensemble: int = 16, nevals: int = 36,
           graph_eval: bool = False, reflection: bool = False,
           resume: bool = False, sparse: bool = False,
           max_folds: int = 0, fold_offset: int = 0, device="cuda") -> list:
    """The main CV loop (run_cv, run_ala.py:75-414) on ``device``. Returns
    the cv rows. Under an initialised process group every rank runs it
    (module docstring) and rank 0 alone writes."""
    writer = not dist.is_initialized() or dist.get_rank() == 0
    if writer:
        os.makedirs(cfg.logdir, exist_ok=True)
        cfg.save(os.path.join(cfg.logdir, "modelparams.json"))

    z, frames, bonds = _from_rank0(lambda: load_frames(
        cfg.data.dataset, cfg.data.ndata, seed=cfg.data.seed, device=device))

    if cfg.data.cg_method in ("minimal", "alpha") and cfg.data.site_index is None:
        # sites come from the topology and the user's n_cgs is overwritten
        # by the site count (datasets.py:262-272)
        from coarsegrainingvae_tpu_torch.data.mappings import derive_site_index
        from coarsegrainingvae_tpu_torch.data.proteins import load_traj_atom_names

        sites = derive_site_index(
            cfg.data.cg_method, z=z, bonds=bonds,
            atom_names=load_traj_atom_names(cfg.data.dataset),
        )
        if len(sites) != cfg.model.n_cgs:
            print(f"cg_method={cfg.data.cg_method}: topology yields "
                  f"{len(sites)} sites; overwriting n_cgs="
                  f"{cfg.model.n_cgs} (reference datasets.py:262-264)")
        cfg = dataclasses.replace(
            cfg,
            model=dataclasses.replace(cfg.model, n_cgs=len(sites)),
            data=dataclasses.replace(cfg.data, site_index=tuple(int(s) for s in sites)),
        )
        if writer:
            cfg.save(os.path.join(cfg.logdir, "modelparams.json"))

    folds = kfold_indices(frames.shape[0], cfg.data.nsplits, cfg.data.seed)
    cv_logger = CSVLogger(os.path.join(cfg.logdir, "cv_stats.csv"), CV_STAT_FIELDS)
    rows = []

    for fold, (train_idx, test_idx) in enumerate(folds):
        if fold < fold_offset:
            continue
        if max_folds and fold >= fold_offset + max_folds:
            break
        t0 = time.time()
        fold_start_ns = time.time_ns()
        split_dir = os.path.join(cfg.logdir, f"fold{fold}")
        mapping = _from_rank0(lambda: build_fold_mapping(
            cfg, z, frames[train_idx], bonds, seed=cfg.data.seed + fold, device=device))
        if writer:
            os.makedirs(split_dir, exist_ok=True)
            with open(os.path.join(split_dir, "mapping.json"), "w") as f:
                json.dump([int(x) for x in mapping], f)

        ds_tr, ds_val, ds_test = fold_datasets(cfg, mapping, z, frames, bonds,
                                               train_idx, test_idx)
        model = build_flagship_model(
            cfg.model, force_sparse=sparse,
            generator=torch.Generator().manual_seed(cfg.data.seed))
        if isinstance(model, CGequiVAE) and not (sparse or cfg.model.sparse) and fold == 0:
            print(f"dec_type={cfg.model.dec_type}: using the sparse "
                  "(segment-sum) formulation")
        steric = None
        if cfg.train.zeta > 0.0:
            steric = build_steric_tables(
                z, bonds, margin=cfg.train.steric_margin,
                frames=frames[train_idx] if cfg.train.steric_data_margin else None)
        trainer = Trainer(model, cfg, device=device, steric_tables=steric)
        state = trainer.init_state(ds_tr.batch(np.arange(min(cfg.data.batch_size, len(ds_tr)))))
        # every rank reads a checkpoint on --resume; rank 0 alone saves
        ckpt = CheckpointManager(os.path.join(split_dir, "ckpt"))
        train_logger = CSVLogger(os.path.join(split_dir, "train_log.csv"))
        state, history = trainer.fit(state, ds_tr, ds_val,
                                     log_fn=train_logger.log if writer else None,
                                     ckpt=ckpt, resume=resume)
        if writer:
            with open(os.path.join(split_dir, "tracing.json"), "w") as f:
                json.dump(tracing.snapshot(since_ns=fold_start_ns), f, indent=1)
        if not history or not np.isfinite(history[-1]["val_recon"]):
            if writer:
                with open(os.path.join(split_dir, "FAILED.txt"), "w") as f:
                    f.write("NaN loss or empty history\n")  # run_ala.py:410-412
            _barrier()
            continue

        seed = cfg.data.seed + 777
        recon = reconstruct_all(trainer, ds_test, seed, batch_size=cfg.data.batch_size,
                                graph_eval=graph_eval, reflection=reflection)
        eval_frames = np.linspace(0, len(ds_test) - 1, min(nevals, len(ds_test))).astype(int)
        samples = sample_ensemble(trainer, ds_test, eval_frames, n_ensemble,
                                  fold_in(seed, 5), graph_eval=graph_eval,
                                  reflection=reflection)

        if writer:
            write_xyz(os.path.join(split_dir, "test_recon.xyz"), recon["recon_xyzs"][:64], z)
            write_xyz(os.path.join(split_dir, "test_samples.xyz"),
                      samples["sample_xyzs"].reshape(-1, z.shape[0], 3)[:128], z)
            # rotating-grid movies for ensemble/data/recon/CG (run_ala.py:407)
            n_show = min(9, samples["sample_xyzs"].shape[0])
            save_grid_snapshots(
                samples["sample_xyzs"][0, :n_show], samples["data_xyzs"][:n_show],
                samples["recon_xyzs"][:n_show], samples["cg_xyzs"][:n_show],
                z, np.full(cfg.model.n_cgs, 6), split_dir,
            )

        def _rmsd_mean(v):
            return float(np.mean(v)) if v is not None and len(np.atleast_1d(v)) else float("nan")

        nan = float("nan")
        row = {
            "fold": fold,
            "epoch": history[-1]["epoch"],
            "train_recon_rmsd": history[-1]["train_recon"] ** 0.5,
            "test_all_recon_rmsd": recon["all_atom_rmsd"],
            "test_heavy_recon_rmsd": recon["heavy_atom_rmsd"],
            "test_all_recon_rmsd_median": recon.get("all_atom_rmsd_median", nan),
            "test_all_recon_rmsd_p99": recon.get("all_atom_rmsd_p99", nan),
            "test_heavy_recon_rmsd_median": recon.get("heavy_atom_rmsd_median", nan),
            "test_heavy_recon_rmsd_p99": recon.get("heavy_atom_rmsd_p99", nan),
            "recon_all_ged": recon.get("all_ged", nan),
            "recon_heavy_ged": recon.get("heavy_ged", nan),
            "recon_all_valid_ratio": recon.get("all_valid_ratio", nan),
            "recon_heavy_valid_ratio": recon.get("heavy_valid_ratio", nan),
            "sample_all_rmsd": _rmsd_mean(samples.get("all_rmsds")),
            "sample_heavy_rmsd": _rmsd_mean(samples.get("heavy_rmsds")),
            "sample_all_ged": samples.get("sample_graph_allatom_val_ratio", nan),
            "sample_heavy_ged": samples.get("sample_graph_val_ratio", nan),
            "sample_all_valid_ratio": samples.get("sample_allatom_valid", nan),
            "sample_heavy_valid_ratio": samples.get("sample_valid", nan),
            "KL": history[-1]["val_KL"],
            "graph": history[-1]["val_graph"],
            "wall_s": time.time() - t0,
        }
        if writer:
            cv_logger.log(row)
        rows.append(row)
        _barrier()
    if writer and len(rows) > 1:
        # multi-fold runs also get the plots.py:21-44-style rollup
        with open(os.path.join(cfg.logdir, "cv_stats_summary.json"), "w") as f:
            json.dump({k: {"mean": m, "std": s}
                       for k, (m, s) in get_cv_stats(cfg.logdir).items()}, f, indent=2)
    return rows


def _barrier() -> None:
    if dist.is_initialized():
        dist.barrier()


def main(argv=None) -> list:
    args = build_parser().parse_args(argv)
    cfg = params_to_config(args)
    task = "recon" if args.det else "sample"
    cfg = dataclasses.replace(
        cfg, logdir=annotate_job(f"{args.cg_method}_{task}_ndata{args.ndata}",
                                 args.logdir, args.n_cgs))
    device = args.device
    launched = init_distributed(torch.device(device).type)
    if launched:
        device = local_device(torch.device(device).type)
    try:
        return run_cv(
            cfg, n_ensemble=args.n_ensemble, nevals=args.nevals,
            graph_eval=args.graph_eval, reflection=args.reflectiontest,
            resume=args.resume, sparse=args.sparse, max_folds=args.max_folds,
            fold_offset=args.fold_offset, device=device,
        )
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
