"""The system under test: the port's ``Trainer`` over a ``DeviceDataset``,
built from the benchmark's frames, topology and weights, and what the
comparison reads of its state.

A configuration's ``model`` names its family, whose program is the
``Program`` of ``cgbench/programs/<model>.py`` (``load``); the families of
the CGVAE build their port model and hand it to ``TrainerProgram``.

The window drives ``Trainer.run_epoch_scan`` (one train step captured as a
CUDA graph and replayed, the index table and the metrics on the card). The
checked steps before it go through ``Trainer._run_program``, the call
``run_epoch_scan`` makes, on the same ``DeviceDataset`` and so the same
captured graph, one step per call with rows the benchmark chose.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
from typing import Dict, List, Optional

import numpy as np
import torch

from cgbench import weights as wt
from cgbench.reference import train as ref_train
from cgbench.reference.train import leaf_norms

# the configuration keys the harness reads itself, and those that only
# document the configuration; every other key goes to both sides
HARNESS_KEYS = {"name", "model", "molecule", "max_atom_edges", "max_cg_edges", "lr_per_sample"}
DOC_KEYS = {"source", "reduced", "assumed", "cg_method", "dataset"}


def load(model: str):
    """The ``Program`` class of the family ``cgbench/programs/<model>.py``."""
    return importlib.import_module(f"cgbench.programs.{model}").Program


def experiment(cfg: dict, traffic: dict, settings: Optional[dict] = None):
    """The port's ``ExperimentConfig`` of a configuration and a traffic mix:
    every key that the reference reads goes into the port's model, train
    or data settings of the same name, and the family's own model
    ``settings`` beside them. A key that neither side reads, or one that
    the port has no setting for, is refused."""
    from coarsegrainingvae_tpu_torch.config import (
        DataConfig,
        ExperimentConfig,
        ModelConfig,
        ParallelConfig,
        TrainConfig,
    )

    shared = ref_train.keys(cfg)
    unused = set(cfg) - shared - HARNESS_KEYS - DOC_KEYS
    if unused:
        raise ValueError(f"configuration keys {sorted(unused)} are read by neither the port's "
                         f"run nor the reference")
    stated = {k: cfg[k] for k in shared if k in cfg}
    parts = {}
    for cls in (ModelConfig, TrainConfig, DataConfig):
        names = {f.name for f in dataclasses.fields(cls)}
        parts[cls] = {k: v for k, v in stated.items() if k in names}
    missing = set(stated) - set().union(*parts.values())
    if missing:
        raise ValueError(f"the port has no setting {sorted(missing)}")
    b = traffic["batch_size"]
    return ExperimentConfig(model=ModelConfig(**parts[ModelConfig], **(settings or {})),
                            data=DataConfig(batch_size=b, **parts[DataConfig]),
                            train=TrainConfig(lr=cfg["lr_per_sample"] * b, **parts[TrainConfig]),
                            parallel=ParallelConfig(zero_optimizer=traffic["zero_optimizer"]))


class TrainerProgram:
    """One ``Trainer`` and its ``DeviceDataset`` on ``device``; a family
    gives ``model``, which builds its port model from the port's model
    settings, and any model ``settings`` of its own."""

    settings: dict = {}

    @staticmethod
    def model(model_cfg) -> torch.nn.Module:
        raise NotImplementedError

    def __init__(self, cfg: dict, traffic: dict, frames: np.ndarray,
                 weights: Dict[str, torch.Tensor], device):
        from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
        from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
        from coarsegrainingvae_tpu_torch.train.losses import build_steric_tables
        from coarsegrainingvae_tpu_torch.train.trainer import Trainer

        exp = experiment(cfg, traffic, self.settings)
        mol = cfg["molecule"]
        z, bonds = np.asarray(mol["z"]), np.asarray(mol["bonds"])
        ds = build_dataset(np.asarray(mol["mapping"]), frames, cfg["atom_cutoff"],
                           cfg["cg_cutoff"], z, bonds, order=exp.data.edgeorder, rotate=False,
                           max_atom_edges=cfg["max_atom_edges"], max_cg_edges=cfg["max_cg_edges"])
        self.dds = DeviceDataset.from_dataset(ds, device)
        tables = None
        if exp.train.zeta != 0.0:
            tables = build_steric_tables(z, bonds, margin=exp.train.steric_margin,
                                         frames=frames if exp.train.steric_data_margin else None)
        with torch.device("meta"):
            model = self.model(exp.model)
        model.to_empty(device=device)
        wt.load(model, weights)
        self.trainer = Trainer(model, exp, device=device, steric_tables=tables)
        self.state = self.trainer.init_state(ds.batch(np.arange(traffic["batch_size"])))
        self.names = list(self.state.params)
        self.sizes = [p.numel() for p in self.state.params.values()]

    def steps(self, rows: np.ndarray, generator: torch.Generator) -> dict:
        """One epoch program over the (S, B) ``rows``: the epoch's metric means."""
        tr = self.trainer
        self.state, out = tr._run_program(self.state, self.dds, rows.astype(np.int32), generator,
                                          True, tr.captures)
        return out

    def epoch(self, generator: torch.Generator, rng: np.random.Generator) -> dict:
        """One epoch of the window: ``Trainer.run_epoch_scan``."""
        self.state, out = self.trainer.run_epoch_scan(self.state, self.dds, generator,
                                                      shuffle_rng=rng)
        return out

    def first_moment_norms(self) -> torch.Tensor:
        """Per-leaf norms of m / (1 - b1), Adam's first moment."""
        b1 = self.trainer.tx.adam.b1
        return leaf_norms(self.state.opt_state.mu.float() / (1 - b1), self.sizes)

    def change_norms(self, start: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Per-leaf norms of the parameters' change from ``start``."""
        with torch.no_grad():
            return torch.stack([torch.linalg.vector_norm(p.double() - start[n].to(p.dtype).double())
                                for n, p in self.state.params.items()])

    def release(self) -> None:
        self.trainer.release_graphs()
        self.trainer = self.state = self.dds = None


@contextlib.contextmanager
def plant(fault: Optional[str]):
    """Within the block, the port's training step is broken underneath the
    harness (for the checks that ``correct`` comes out false):
    "state_unchanged" (the update leaves parameters and moments as they
    were), "half_batch" (the step sees the first half of its rows, the mean
    taken over them), "no_exchange" (ranks skip the all-reduce of gradient,
    loss and metrics). None breaks nothing."""
    if fault is None:
        yield
        return
    from coarsegrainingvae_tpu_torch.data.batch import CGBatch
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    if fault == "state_unchanged":
        def apply_flat(self, state, loss, g):
            ok = torch.ones((), dtype=torch.bool, device=g.device)
            return dataclasses.replace(state, step=state.step + 1), ok
        name, broken = "_apply_flat", apply_flat
    elif fault == "half_batch":
        loss_and_grads = Trainer.loss_and_grads

        def half(self, state, batch, generator=None, denominators=None):
            k = batch.z.shape[0] // 2
            batch = CGBatch(**{f.name: None if getattr(batch, f.name) is None
                               else getattr(batch, f.name)[:k]
                               for f in dataclasses.fields(batch)})
            return loss_and_grads(self, state, batch, generator, None)
        name, broken = "loss_and_grads", half
    elif fault == "no_exchange":
        def local(self, parts: List[torch.Tensor]) -> torch.Tensor:
            return torch.cat([t.reshape(-1).to(torch.float32) for t in parts])
        name, broken = "_all_reduce", local
    else:
        raise ValueError(f"unknown fault {fault!r}")
    original = getattr(Trainer, name)
    setattr(Trainer, name, broken)
    try:
        yield
    finally:
        setattr(Trainer, name, original)
