"""Train the port at depth and set its folds beside the JAX package's runs.

Runs the commands of two committed JAX results through the port's
``cli.run_cgvae`` on the card:

- ``demo``: ``examples/results/dipeptide_demo/README.md``'s command
  (n_basis 128, 2,000 frames, newman, 2 folds, patience 40, up to 400
  epochs, ``--graph_eval``);
- ``r5``: one fold of ``examples/results/dipeptide_5fold``'s ``r5_*`` recipe
  (bench width, 20,000 frames, B 128, 600 epochs, cgae).

Each run's ``cv_stats.csv``, train logs, ``modelparams.json`` and console log
are copied to ``--out``; checkpoints stay in ``--runs``. A JSON summary (card,
power limit, wall time per run, each fold's RMSDs and stop epoch) goes to
``<out>/summary.json``. ``--rehearse`` cuts every run to a few seconds on the
CPU to check the flags.

    python3 scripts/learning_check.py --which demo r5
"""

from __future__ import annotations

import argparse
import csv
import glob
import json
import os
import shutil
import subprocess
import sys
import time

DEMO = ("-dataset dipeptide -n_cgs 3 -n_basis 128 -n_rbf 8 -atom_cutoff 8.5 "
        "-cg_cutoff 9.5 -enc_nconv 2 -dec_nconv 3 -batch_size 32 -ndata 2000 "
        "-nepochs 400 -nsplits 2 -beta 0.05 -gamma 25.0 -lr 3e-4 -patience 40 "
        "-cg_method newman --dec_type pseudo --graph_eval -n_ensemble 4 "
        "-nevals 8 -seed 0")
R5 = ("-dataset dipeptide -n_cgs 3 -batch_size 128 -ndata 20000 -nepochs 600 "
      "-lr 3.2e-4 -n_basis 600 -n_rbf 8 -atom_cutoff 8.5 -cg_cutoff 9.5 "
      "-nsplits 5 -beta 0.05 -gamma 25.0 -enc_nconv 4 -dec_nconv 5 "
      "-cg_method cgae -edgeorder 2 --dec_type pseudo --graph_eval "
      "-n_ensemble 16 -nevals 36 -patience 600 -factor 0.9 -lr_patience 10 "
      "-min_lr 1e-13 -seed 123 -max_folds 1")
RECIPES = {"demo": DEMO, "r5": R5}
# flags that cut a recipe to a few CPU seconds (later flags win in argparse)
REHEARSE = ("-ndata 48 -nepochs 2 -n_basis 16 -batch_size 16 -n_ensemble 2 "
            "-nevals 2 --device cpu")


def _card() -> dict:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.TimeoutExpired):
        out = "not measured (no nvidia-smi)"
    return {"nvidia_smi": out}


def run_one(name: str, runs: str, out: str, timeout: float, rehearse: bool) -> dict:
    logdir = os.path.join(runs, name)
    argv = RECIPES[name].split() + ["-logdir", logdir]
    if rehearse:
        argv += REHEARSE.split()
    cmd = [sys.executable, "-m", "coarsegrainingvae_tpu_torch.cli.run_cgvae", *argv]
    os.makedirs(out, exist_ok=True)
    t0 = time.time()
    with open(os.path.join(out, f"{name}.log"), "w") as log:
        try:
            rc = subprocess.run(cmd, stdout=log, stderr=subprocess.STDOUT,
                                timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            rc = 124
    wall = time.time() - t0
    res = {"command": " ".join(cmd[1:]), "rc": rc, "wall_s": wall, "folds": []}
    run_dirs = sorted(glob.glob(logdir + "_*"))
    if not run_dirs:
        return res
    run_dir = run_dirs[-1]
    dest = os.path.join(out, name)
    os.makedirs(dest, exist_ok=True)
    for f in ("cv_stats.csv", "cv_stats_summary.json", "modelparams.json"):
        if os.path.exists(os.path.join(run_dir, f)):
            shutil.copy(os.path.join(run_dir, f), dest)
    for log_path in sorted(glob.glob(os.path.join(run_dir, "fold*", "train_log.csv"))):
        fold = os.path.basename(os.path.dirname(log_path))
        shutil.copy(log_path, os.path.join(dest, f"{fold}_train_log.csv"))
        with open(log_path) as f:
            rows = list(csv.DictReader(f))
        res.setdefault("train_s", {})[fold] = sum(float(r["epoch_time_s"]) for r in rows)
        res.setdefault("epochs", {})[fold] = len(rows)
    stats = os.path.join(run_dir, "cv_stats.csv")
    if os.path.exists(stats):
        with open(stats) as f:
            for r in csv.DictReader(f):
                res["folds"].append({k: r[k] for k in (
                    "fold", "epoch", "test_all_recon_rmsd", "test_heavy_recon_rmsd",
                    "sample_all_rmsd", "recon_heavy_valid_ratio",
                    "sample_heavy_valid_ratio", "wall_s")})
    return res


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--which", nargs="+", default=["demo"], choices=sorted(RECIPES))
    p.add_argument("--runs", default="build/learning_check")
    p.add_argument("--out", default="chiprun_out/learning_check")
    p.add_argument("--timeout", type=float, nargs="+", default=[1500.0, 2100.0],
                   help="seconds per run, in --which order")
    p.add_argument("--rehearse", action="store_true")
    args = p.parse_args(argv)
    shutil.rmtree(args.runs, ignore_errors=True)
    summary = {"card": _card(), "runs": {}}
    print(summary["card"]["nvidia_smi"], flush=True)
    for i, name in enumerate(args.which):
        t = args.timeout[min(i, len(args.timeout) - 1)]
        summary["runs"][name] = run_one(name, args.runs, args.out, t, args.rehearse)
        print(json.dumps({name: summary["runs"][name]}), flush=True)
        with open(os.path.join(args.out, "summary.json"), "w") as f:
            json.dump(summary, f, indent=2)
    return max(r["rc"] for r in summary["runs"].values())


if __name__ == "__main__":
    sys.exit(main())
