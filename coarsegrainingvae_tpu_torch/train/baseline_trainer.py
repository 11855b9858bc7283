"""Training of the non-VAE baselines (port of
``coarsegrainingvae_tpu.train.baseline_trainer``; run_baseline.py:121-408
of the original code). Loss = coordinate MSE + gamma * the MSE of the
graph-loss edge lengths (run_baseline.py:146-149).

The step is one eager call per batch: forward, loss, backward, the
finite-loss / finite-gradient guard, then Adam with float32 moments and no
clip (``train.trainer.guarded_update``); a rejected batch keeps the
parameters and the moments, and ``step`` advances all the same.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.diffpool import DiffPoolBatch, DiffPoolDatasetArrays
from coarsegrainingvae_tpu_torch.train.controller import EarlyStopping, LowessPlateauController
from coarsegrainingvae_tpu_torch.train.diffpool_trainer import epoch_means
from coarsegrainingvae_tpu_torch.train.trainer import AdamState, guarded_update, make_optimizer

EPS = 1e-3


@dataclass
class BaselineTrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own, updated in place
    opt_state: AdamState
    step: int
    lr: float


def baseline_loss(xyz: torch.Tensor, x_recon: torch.Tensor, bonds: torch.Tensor,
                  gamma: float) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    loss_recon = torch.mean((x_recon - xyz) ** 2)
    gen_d = torch.sqrt(torch.sum((x_recon[:, bonds[:, 0]] - x_recon[:, bonds[:, 1]]) ** 2, -1)
                       + EPS)
    dat_d = torch.sqrt(torch.sum((xyz[:, bonds[:, 0]] - xyz[:, bonds[:, 1]]) ** 2, -1) + EPS)
    loss_graph = torch.mean((gen_d - dat_d) ** 2)
    total = loss_recon + gamma * loss_graph
    return total, {"loss": total, "recon": loss_recon, "graph": loss_graph}


class BaselineTrainer:
    """Adam training of any baseline of the zoo (``forward(xyz)`` ->
    (target, reconstruction)) on one device: the card unless the caller
    passes ``device="cpu"``. The model is moved there."""

    def __init__(self, model: torch.nn.Module, gamma: float = 0.0, lr: float = 1e-3,
                 seed: int = 123, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.gamma = gamma
        self.base_lr = lr
        self.seed = seed
        self.tx = make_optimizer(float("inf"), "float32")

    def init_state(self) -> BaselineTrainState:
        """Adam state for the model's current parameters, step 0."""
        params = dict(self.model.named_parameters())
        return BaselineTrainState(params=params, opt_state=self.tx.init(list(params.values())),
                                  step=0, lr=self.base_lr)

    def loss(self, batch: DiffPoolBatch) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        xyz, x_recon = self.model(batch.xyz)
        return baseline_loss(xyz, x_recon, batch.bonds, self.gamma)

    def train_step(self, state: BaselineTrainState, batch: DiffPoolBatch
                   ) -> Tuple[BaselineTrainState, Dict[str, torch.Tensor]]:
        batch = batch.to(self.device)
        params = list(state.params.values())
        total, metrics = self.loss(batch)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        opt_state, _ = guarded_update(self.tx, params, grads, metrics["loss"].detach(),
                                      state.opt_state, state.lr, float("inf"))
        return (BaselineTrainState(params=state.params, opt_state=opt_state,
                                   step=state.step + 1, lr=state.lr),
                {k: v.detach() for k, v in metrics.items()})

    def eval_step(self, batch: DiffPoolBatch) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            return self.loss(batch.to(self.device))[1]

    def reconstruct(self, batch: DiffPoolBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        """(target, reconstruction) of a host batch, on the device."""
        with torch.no_grad():
            return self.model(batch.to(self.device).xyz)

    def run_epoch(self, state: BaselineTrainState, dataset: DiffPoolDatasetArrays,
                  batch_size: int, train: bool = True,
                  shuffle_rng: Optional[np.random.Generator] = None
                  ) -> Tuple[BaselineTrainState, Dict[str, float]]:
        agg: Dict[str, list] = {}
        for batch in dataset.iter_batches(batch_size, rng=shuffle_rng if train else None):
            if train:
                state, metrics = self.train_step(state, batch)
            else:
                metrics = self.eval_step(batch)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        return state, epoch_means(agg)

    def fit(self, state: BaselineTrainState, trainset: DiffPoolDatasetArrays,
            valset: DiffPoolDatasetArrays, nepochs: int, batch_size: int, patience: int = 20,
            lr_patience: int = 10, lr_factor: float = 0.6, min_lr: float = 1e-8, log_fn=None):
        """Train with the LOWESS plateau LR and early stopping."""
        controller = LowessPlateauController(lr=self.base_lr, factor=lr_factor,
                                             patience=lr_patience, min_lr=min_lr)
        stopper = EarlyStopping(patience=patience)
        shuffle_rng = np.random.default_rng(self.seed)
        history = []
        for epoch in range(nepochs):
            t0 = time.time()
            state, train_m = self.run_epoch(state, trainset, batch_size, train=True,
                                            shuffle_rng=shuffle_rng)
            _, val_m = self.run_epoch(state, valset, batch_size, train=False)
            smoothed = controller.step(val_m["loss"])
            state.lr = controller.lr
            row = {
                "epoch": epoch, "lr": controller.lr,
                "train_loss": train_m["loss"], "val_loss": val_m["loss"],
                "train_recon": train_m["recon"], "val_recon": val_m["recon"],
                "train_graph": train_m["graph"], "val_graph": val_m["graph"],
                "epoch_time_s": time.time() - t0,
            }
            history.append(row)
            if log_fn is not None:
                log_fn(row)
            if controller.converged:
                break
            stopper(smoothed)
            if stopper.early_stop or not np.isfinite(val_m["recon"]):
                break
        return state, history
