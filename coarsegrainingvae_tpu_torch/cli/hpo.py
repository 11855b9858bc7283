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
"""
from __future__ import annotations

import argparse
import itertools
import math
import os
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np

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


def _evaluate(objective: Callable[..., float], cfg: Dict[str, Any], *args
              ) -> Tuple[Dict[str, Any], float, bool, float]:
    """(cfg, value, failed, wall seconds) of one trial; an exception is
    data: the trial is failed and its cfg carries the error."""
    t0 = time.monotonic()
    try:
        val = float(objective(cfg, *args))
        failed = not np.isfinite(val)
    except Exception as e:  # noqa: BLE001 - a failed trial is data
        val, failed = float("nan"), True
        cfg = dict(cfg, error=repr(e)[:200])
    return cfg, val, failed, round(time.monotonic() - t0, 3)


def random_search(objective: Callable[[Dict[str, Any]], float], space: Dict[str, Tuple],
                  n_trials: int, seed: int = 0, log_path: str = "hpo_log.csv"
                  ) -> Tuple[Dict[str, Any], float, List[Dict]]:
    """Minimise ``objective`` over ``n_trials`` draws."""
    rng = np.random.default_rng(seed)
    logger = CSVLogger(log_path)
    best, best_val = None, math.inf
    rows = []
    for t in range(n_trials):
        cfg, val, failed, wall = _evaluate(objective, sample_config(space, rng))
        row = dict(cfg, trial=t, value=val, failed=failed, wall_s=wall)
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
    ``objective(cfg, epochs)`` is re-run from scratch at each budget."""
    rng = np.random.default_rng(seed)
    logger = CSVLogger(log_path)
    trials = [sample_config(space, rng) for _ in range(n_trials)]
    epochs, rung = min_epochs, 0
    rows: List[Dict] = []
    while trials:
        scored = []
        for cfg in trials:
            cfg, val, failed, wall = _evaluate(objective, cfg, epochs)
            row = dict(cfg, rung=rung, epochs=epochs, value=val, failed=failed, wall_s=wall)
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


def _cv_objective(args: argparse.Namespace):
    """The CLI's objective: a short CV run on ``args.device``, returning
    the folds' mean test all-atom recon RMSD."""
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
        rows = run_cv(exp, n_ensemble=2, nevals=4, graph_eval=False, device=args.device)
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
    os.makedirs(args.logdir, exist_ok=True)
    obj = _cv_objective(args)
    if args.strategy == "random":
        best, val, _ = random_search(lambda c: obj(c), CGVAE_SPACE, args.n_trials,
                                     seed=args.seed,
                                     log_path=os.path.join(args.logdir, "hpo_log.csv"))
    else:
        best, val, _ = asha_search(obj, CGVAE_SPACE, args.n_trials, seed=args.seed,
                                   min_epochs=max(args.nepochs // 4, 1),
                                   max_epochs=args.nepochs,
                                   log_path=os.path.join(args.logdir, "hpo_asha_log.csv"))
    print({"best": best, "value": val})
    return best, val


if __name__ == "__main__":
    main()
