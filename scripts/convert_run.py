#!/usr/bin/env python3
"""Move a ``run_cgvae`` run between the JAX package and the PyTorch port.

    python scripts/convert_run.py --to torch RUN_OR_FOLD_DIR   # orbax -> torch
    python scripts/convert_run.py --to jax RUN_OR_FOLD_DIR     # torch -> orbax

Runs where JAX, flax and orbax are installed (it imports both packages).
A fold is a directory with ``mapping.json`` and ``ckpt/``; a run directory
is converted fold by fold. The run's ``modelparams.json`` (the fold's
parent directory, or ``--modelparams``) rebuilds JAX's template train state
as JAX's ``Backmapper.from_run`` does. ``--to torch`` restores every orbax
step with its ``meta_<step>.json`` and writes it in the port's checkpoint
layout through ``convert.train_state_from_flax``; ``--to jax`` reads every
port step and writes it with JAX's own ``CheckpointManager`` through
``convert.train_state_to_flax``. The checkpoints that were there move to
``ckpt_jax/`` or ``ckpt_torch/`` beside the new ``ckpt/``; ``mapping.json``,
the CSVs and ``modelparams.json`` stay as they are. This script does only
the orbax I/O: the mapping of the trees is the port's ``convert`` module.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path
from typing import List

import jax
import ml_dtypes
import numpy as np
import torch
from flax import serialization

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from coarsegrainingvae_tpu.config import ExperimentConfig as JaxConfig  # noqa: E402
from coarsegrainingvae_tpu.data.dataset import build_dataset  # noqa: E402
from coarsegrainingvae_tpu.data.proteins import load_frames  # noqa: E402
from coarsegrainingvae_tpu.models.cgvae import build_flagship_model  # noqa: E402
from coarsegrainingvae_tpu.train.checkpoint import CheckpointManager as JaxCkpt  # noqa: E402
from coarsegrainingvae_tpu.train.trainer import Trainer  # noqa: E402
from coarsegrainingvae_tpu_torch.config import ExperimentConfig as PortConfig  # noqa: E402
from coarsegrainingvae_tpu_torch.convert import (  # noqa: E402
    train_state_from_flax,
    train_state_to_flax,
)
from coarsegrainingvae_tpu_torch.train.checkpoint import (  # noqa: E402
    CheckpointManager as PortCkpt,
)
from coarsegrainingvae_tpu_torch.train.checkpoint import _is_orbax_step  # noqa: E402


def jax_template(modelparams: str, fold_dir: str):
    """JAX's template TrainState of a fold (serve.py:78-105)."""
    cfg = JaxConfig.load(modelparams)
    with open(os.path.join(fold_dir, "mapping.json")) as f:
        mapping = np.asarray(json.load(f), np.int32)
    z, frames, bonds = load_frames(cfg.data.dataset, 8, seed=cfg.data.seed)
    ds = build_dataset(mapping, frames, cfg.model.atom_cutoff, cfg.model.cg_cutoff, z,
                       bonds, order=cfg.data.edgeorder, rotate=False, seed=cfg.data.seed)
    trainer = Trainer(build_flagship_model(cfg.model), cfg)
    return trainer.init_state(ds.batch(np.arange(min(8, len(ds)))), seed=cfg.data.seed)


def _numpy(leaf):
    """A tree leaf of the port (numpy, or a bf16 CPU tensor) as numpy."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
        return leaf.numpy()
    return np.asarray(leaf)


def _as_numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _as_numpy_tree(v) for k, v in tree.items()}
    return _numpy(tree)


def _swap_dirs(fold_dir: str, old_name: str) -> str:
    """Move ``ckpt/`` to ``old_name/`` and return the path of the new, empty
    ``ckpt/``."""
    ckpt, old = os.path.join(fold_dir, "ckpt"), os.path.join(fold_dir, old_name)
    if os.path.exists(old):
        raise FileExistsError(f"{old} exists: the fold was converted before")
    os.replace(ckpt, old)
    return ckpt


def to_torch(fold_dir: str, modelparams: str) -> List[int]:
    template = jax_template(modelparams, fold_dir)
    cfg = PortConfig.load(modelparams)
    src = os.path.join(fold_dir, "ckpt")
    jmgr = JaxCkpt(src)
    steps = sorted(jmgr._mgr.all_steps())
    states = {s: jmgr.restore(template, step=s) for s in steps}
    jmgr.close()
    dst = _swap_dirs(fold_dir, "ckpt_jax")
    mgr = PortCkpt(dst, max_to_keep=0)
    for step, (state, meta, _) in states.items():
        payload = train_state_from_flax(
            serialization.to_state_dict(jax.device_get(state)), cfg)
        mgr.save_payload(step, payload, metadata=meta or None)
    return steps


def to_jax(fold_dir: str, modelparams: str) -> List[int]:
    template = jax_template(modelparams, fold_dir)
    cfg = PortConfig.load(modelparams)
    src = os.path.join(fold_dir, "ckpt")
    pmgr = PortCkpt(src)
    steps = pmgr.all_steps()
    read = {s: pmgr.read(s) for s in steps}
    dst = _swap_dirs(fold_dir, "ckpt_torch")
    jmgr = JaxCkpt(dst, max_to_keep=max(len(steps), 1))
    for step, (payload, meta, _) in read.items():
        tree = _as_numpy_tree(train_state_to_flax(payload, cfg))
        jmgr.save(step, serialization.from_state_dict(template, tree), metadata=meta or None)
    jmgr.close()
    return steps


def fold_dirs(path: str) -> List[str]:
    if os.path.exists(os.path.join(path, "mapping.json")):
        return [path]
    folds = sorted(str(p) for p in Path(path).glob("fold*")
                   if (p / "mapping.json").exists() and (p / "ckpt").is_dir())
    if not folds:
        raise FileNotFoundError(f"{path} holds no fold (mapping.json and ckpt/)")
    return folds


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("path", help="a run directory or one fold of it")
    p.add_argument("--to", required=True, choices=("torch", "jax"))
    p.add_argument("--modelparams", default=None,
                   help="the run's modelparams.json (default: beside the folds)")
    a = p.parse_args(argv)
    for fold in fold_dirs(a.path):
        modelparams = a.modelparams or os.path.join(os.path.dirname(os.path.abspath(fold)),
                                                    "modelparams.json")
        ckpt = os.path.join(fold, "ckpt")
        orbax = any(_is_orbax_step(os.path.join(ckpt, d)) for d in os.listdir(ckpt)
                    if d.isdigit())
        if orbax != (a.to == "torch"):
            raise ValueError(f"{ckpt} holds {'orbax' if orbax else 'torch'} checkpoints; "
                             f"--to {a.to} converts the other kind")
        steps = (to_torch if a.to == "torch" else to_jax)(fold, modelparams)
        print(json.dumps({"fold": fold, "to": a.to, "steps": steps}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
