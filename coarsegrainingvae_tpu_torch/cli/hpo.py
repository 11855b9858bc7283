"""Hyperparameter search (port of ``coarsegrainingvae_tpu.cli.hpo``; the
local stand-in for the original code's hosted SigOpt loops, scripts/opt.py
and its siblings).

A seeded random search or successive halving (ASHA-style) over the main
CGequiVAE search space (opt.py:63-83), minimising the mean test all-atom
reconstruction RMSD of a short CV run of ``cli.run_cgvae.run_cv`` per
trial, whose dense model runs the CUDA message kernels on the card. Each
trial writes its run under ``<logdir>/trial_%04d`` (numbered in call
order, so equal seeds give equal directories) and one row of
``hpo_log.csv`` / ``hpo_asha_log.csv`` with a ``failed`` flag. A trial
that raises is recorded as failed and the search goes on (opt.py:147-160).
A CUDA error is not recoverable in one process: every later trial fails
with it too.

    python -m coarsegrainingvae_tpu_torch.cli.hpo -strategy asha -n_trials 6 \\
        -dataset dipeptide -n_cgs 3 -ndata 400 -nepochs 8 [--device cpu]

The run_cgvae CLI's flags (``--device`` included, default ``cuda``) plus
``-n_trials`` and ``-strategy``. Like the JAX package, a trial runs every
fold: ``-max_folds`` does not reach the objective.

Under ``torchrun`` (WORLD_SIZE set) every trial trains data-parallel over
all the node's ranks, as the JAX CLI's trials train over every local chip
(``run_cgvae.run_cv`` under a process group):

    torchrun --nproc_per_node 4 -m coarsegrainingvae_tpu_torch.cli.hpo ...

NCCL for ``--device cuda`` (rank r on cuda:LOCAL_RANK), gloo for
``--device cpu``. Rank 0's draws are broadcast (each random draw, each
ASHA rung's configs), every rank runs each trial in the same order (so
the trial directories agree), a trial is failed on every rank when it
failed on any (one all-gather of each rank's error after the trial), and
rank 0 alone writes the logs and prints the best. A rank that raises
inside a trial's collectives leaves its peers waiting there until the
process group's timeout.
"""
from __future__ import annotations

import argparse
import itertools
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from coarsegrainingvae_tpu_torch.cli.run_cgvae import _from_rank0
from coarsegrainingvae_tpu_torch.parallel.mesh import init_distributed, local_device
from coarsegrainingvae_tpu_torch.utils.logging import CSVLogger

# the search space of the main CGequiVAE HPO (opt.py:63-83)
CGVAE_SPACE: Dict[str, Tuple] = {
    "lr": ("log", 1e-5, 1e-3),
    "beta": ("log", 1e-3, 1.0),
    "gamma": ("log", 1.0, 100.0),
    "n_basis": ("int", 64, 600),
    "n_rbf": ("int", 5, 12),
    "enc_nconv": ("int", 2, 5),
    "dec_nconv": ("int", 2, 7),
    "atom_cutoff": ("float", 4.0, 12.0),
    "cg_cutoff": ("float", 6.0, 30.0),
}


def sample_config(space: Dict[str, Tuple], rng: np.random.Generator) -> Dict[str, Any]:
    """One draw of every key of ``space``, in its order."""
    out: Dict[str, Any] = {}
    for k, (kind, lo, hi) in space.items():
        if kind == "log":
            out[k] = float(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        elif kind == "int":
            out[k] = int(rng.integers(lo, hi + 1))
        elif kind == "float":
            out[k] = float(rng.uniform(lo, hi))
        elif kind == "choice":
            out[k] = lo[rng.integers(0, len(lo))]
        else:
            raise ValueError(kind)
    return out


def _writer() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _evaluate(objective: Callable[..., float], cfg: Dict[str, Any], *args
              ) -> Tuple[Dict[str, Any], float, bool, float]:
    """(cfg, value, failed, wall seconds) of one trial; an exception is
    data: the trial is failed and its cfg carries the error. Under a
    process group the ranks agree: one all-gather of each rank's error
    (None if it had none) fails the trial on every rank when any rank
    failed, with the first rank's error."""
    t0 = time.monotonic()
    error: Optional[str] = None
    try:
        val = float(objective(cfg, *args))
        failed = not np.isfinite(val)
    except Exception as e:  # noqa: BLE001 - a failed trial is data
        val, failed = float("nan"), True
        error = repr(e)[:200]
    if dist.is_initialized():
        errors: List[Optional[str]] = [None] * dist.get_world_size()
        dist.all_gather_object(errors, error)
        raised = [e for e in errors if e is not None]
        if raised:
            val, failed, error = float("nan"), True, raised[0]
    if error is not None:
        cfg = dict(cfg, error=error)
    return cfg, val, failed, round(time.monotonic() - t0, 3)


def random_search(objective: Callable[[Dict[str, Any]], float], space: Dict[str, Tuple],
                  n_trials: int, seed: int = 0, log_path: str = "hpo_log.csv"
                  ) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """Minimise ``objective`` over ``n_trials`` draws (rank 0's, and only
    rank 0 logs, under a process group)."""
    rng = np.random.default_rng(seed)
    logger = CSVLogger(log_path) if _writer() else None
    best, best_val = None, math.inf
    rows = []
    for t in range(n_trials):
        cfg, val, failed, wall = _evaluate(objective,
                                           _from_rank0(lambda: sample_config(space, rng)))
        row = dict(cfg, trial=t, value=val, failed=failed, wall_s=wall)
        if logger is not None:
            logger.log(row)
        rows.append(row)
        if not failed and val < best_val:
            best, best_val = {k: v for k, v in cfg.items() if k in space}, val
    return best, best_val, rows


def asha_search(objective: Callable[[Dict[str, Any], int], float], space: Dict[str, Tuple],
                n_trials: int, min_epochs: int = 2, max_epochs: int = 16, reduction: int = 4,
                seed: int = 0, log_path: str = "hpo_asha_log.csv"
                ) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """Successive halving: every trial runs ``min_epochs``, the best
    1/reduction advance to reduction x the epochs, up to ``max_epochs``;
    ``objective(cfg, epochs)`` is re-run from scratch at each budget. Under
    a process group every rung runs rank 0's configs and only rank 0
    logs."""
    rng = np.random.default_rng(seed)
    logger = CSVLogger(log_path) if _writer() else None
    trials = [sample_config(space, rng) for _ in range(n_trials)]
    epochs, rung = min_epochs, 0
    rows: List[Dict] = []
    while trials:
        trials = _from_rank0(lambda: trials)
        scored = []
        for cfg in trials:
            cfg, val, failed, wall = _evaluate(objective, cfg, epochs)
            row = dict(cfg, rung=rung, epochs=epochs, value=val, failed=failed, wall_s=wall)
            if logger is not None:
                logger.log(row)
            rows.append(row)
            if not failed:
                scored.append((val, {k: v for k, v in cfg.items() if k in space}))
        scored.sort(key=lambda x: x[0])
        if epochs >= max_epochs or len(scored) <= 1:
            if scored:
                return scored[0][1], scored[0][0], rows
            return {}, math.inf, rows
        trials = [cfg for _, cfg in scored[:max(len(scored) // reduction, 1)]]
        epochs = min(epochs * reduction, max_epochs)
        rung += 1
    return {}, math.inf, rows


def _cv_objective(args: argparse.Namespace, device=None):
    """The CLI's objective: a short CV run on ``device`` (``args.device``
    by default), returning the folds' mean test all-atom recon RMSD."""
    from coarsegrainingvae_tpu_torch.cli.run_cgvae import params_to_config, run_cv
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig

    # both strategies call the objective in a fixed order, so equal seeds
    # name equal trial directories
    trial_counter = itertools.count()

    def objective(cfg: Dict[str, Any], epochs: int = None) -> float:
        ns = argparse.Namespace(**vars(args))
        for k, v in cfg.items():
            setattr(ns, k, v)
        ns.nepochs = epochs if epochs is not None else args.nepochs
        exp = params_to_config(ns)
        exp = ExperimentConfig(
            model=exp.model, data=exp.data, train=exp.train, parallel=exp.parallel,
            logdir=os.path.join(args.logdir, f"trial_{next(trial_counter):04d}"))
        rows = run_cv(exp, n_ensemble=2, nevals=4, graph_eval=False,
                      device=args.device if device is None else device)
        if not rows:
            return float("nan")
        return float(np.mean([r["test_all_recon_rmsd"] for r in rows]))

    return objective


def build_parser() -> argparse.ArgumentParser:
    """run_cgvae's parser plus ``-n_trials`` and ``-strategy``."""
    from coarsegrainingvae_tpu_torch.cli import run_cgvae

    p = run_cgvae.build_parser()
    p.add_argument("-n_trials", type=int, default=8)
    p.add_argument("-strategy", type=str, default="random", choices=["random", "asha"])
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = args.device
    launched = init_distributed(torch.device(device).type)
    if launched:
        device = local_device(torch.device(device).type)
    try:
        if _writer():
            os.makedirs(args.logdir, exist_ok=True)
        obj = _cv_objective(args, device)
        if args.strategy == "random":
            best, val, _ = random_search(lambda c: obj(c), CGVAE_SPACE, args.n_trials,
                                         seed=args.seed,
                                         log_path=os.path.join(args.logdir, "hpo_log.csv"))
        else:
            best, val, _ = asha_search(obj, CGVAE_SPACE, args.n_trials, seed=args.seed,
                                       min_epochs=max(args.nepochs // 4, 1),
                                       max_epochs=args.nepochs,
                                       log_path=os.path.join(args.logdir, "hpo_asha_log.csv"))
        if _writer():
            print({"best": best, "value": val})
        return best, val
    finally:
        if launched:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
