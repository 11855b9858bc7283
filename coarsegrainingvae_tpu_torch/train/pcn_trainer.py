"""PCN (protein backmapping) training (port of
``coarsegrainingvae_tpu.train.pcn_trainer``; scripts/run_pdb.py and
pcn_utils.py of the original code).

Loss = recon + aux_scale * (gamma * graph + kappa * dihedral)
(pcn_utils.py:185-193), with the repo's extensions: the excluded-volume
hinge of multi-topology batches (``zeta``, ramped over ``zeta_warmup``
steps), the rooted bond projection (``bond_project``) and, for
``StochasticPCN``, beta * KL. The step is the JAX package's: forward,
loss, backward, the skip-batch guard, a global-norm clip, then Adam with
float32 moments (``train.trainer.guarded_update``); a skipped batch keeps
the parameters and the moments, and the step counter advances all the same.

Like the JAX package's production loop (bench.py:189-198) the step is one
eager call per batch: each padded multi-protein batch is copied to the
device and stepped there, with no host synchronisation inside the step; the
epoch's metrics are read back once at its end. ``aux_warmup`` counts
epochs, ``zeta_warmup`` steps; the plateau controller and the stopper hold
while either ramp runs, and ``fit`` returns the best validation epoch's
parameters. The stochastic model's noise comes from generators seeded from
(seed + 1, step) in training and (seed,) in evaluation, the stand-ins for
the JAX package's ``fold_in`` keys.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.batch import CGBatch, flatten_ids
from coarsegrainingvae_tpu_torch.data.sidechain import PCNDatasetArrays
from coarsegrainingvae_tpu_torch.models.cgvae import (
    FlatGraph,
    StochasticPCN,
    VAEOutput,
    flatten_batch,
    project_bonds_rooted,
)
from coarsegrainingvae_tpu_torch.ops.geometry import dihedral
from coarsegrainingvae_tpu_torch.train.controller import EarlyStopping, LowessPlateauController
from coarsegrainingvae_tpu_torch.train.losses import (
    graph_loss,
    kl_divergence,
    recon_loss,
    steric_loss_batched,
)
from coarsegrainingvae_tpu_torch.train.trainer import (
    AdamState,
    _mean,
    guarded_update,
    make_optimizer,
)
from coarsegrainingvae_tpu_torch.utils.rng import generator as derived_generator


@dataclass
class PCNTrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own, updated in place
    opt_state: AdamState
    step: int                               # optimizer steps taken, skipped ones too
    lr: float


def pcn_loss(out: VAEOutput, g: FlatGraph, quads: torch.Tensor, quad_mask: torch.Tensor,
             gamma: float, kappa: float, aux_scale: float = 1.0, zeta: float = 0.0,
             steric_batch=None, steric_margin: float = 0.3
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total, metrics). quads (B*Q, 4) flat atom ids with quad_mask
    (B*Q,). aux_scale ramps the graph and dihedral terms in: the JAX
    package found recon-first training reaches 0.011 where the full loss
    from step 0 stalls recon at ~0.87 on 50-60-residue synthetics
    (pcn_trainer.py:43-50 there). steric_batch (z, bonds, bond_mask) of the
    padded batch adds zeta * ``steric_loss_batched``; the trainer passes it
    for a non-zero zeta only, as the JAX package does."""
    loss_recon = recon_loss(out.xyz, out.xyz_recon, g.atom_mask)
    loss_graph = graph_loss(out.xyz, out.xyz_recon, g.bonds, g.bond_mask)
    gen = dihedral(out.xyz_recon, quads)
    dat = dihedral(out.xyz, quads)
    m = quad_mask.to(gen.dtype)
    loss_dihe = torch.sum((gen - dat) ** 2 * m) / torch.clamp(torch.sum(m), min=1.0)
    total = loss_recon + aux_scale * (gamma * loss_graph + kappa * loss_dihe)
    metrics = {"loss": total, "recon": loss_recon, "graph": loss_graph, "dihe": loss_dihe}
    if steric_batch is not None:
        z_b, bonds_b, bond_mask_b = steric_batch
        loss_steric = steric_loss_batched(out.xyz_recon, z_b, bonds_b, bond_mask_b,
                                          margin=steric_margin)
        total = total + zeta * loss_steric
        metrics.update(loss=total, steric=loss_steric)
    return total, metrics


class PCNTrainer:
    """Train and eval steps, reconstruction, ensembles and ``fit`` for a
    ``PCN`` or ``StochasticPCN`` on one device: the card unless the caller
    passes ``device="cpu"``. The model is moved there; its parameters are
    the ones it was built with (drawn from its generator)."""

    def __init__(self, model: torch.nn.Module, gamma: float = 25.0, kappa: float = 1.0,
                 lr: float = 1e-4, grad_clip: float = 0.01,
                 loss_skip_factor: float = 300.0,  # pcn_utils.py:197-200
                 seed: int = 123, aux_warmup: int = 0, zeta: float = 0.0,
                 steric_margin: float = 0.3, zeta_warmup: int = 0,
                 bond_project: bool = False, bond_project_eval: bool = False,
                 beta: float = 0.0, device="cuda"):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.stochastic = isinstance(model, StochasticPCN)
        self.beta = float(beta)
        self.gamma, self.kappa = gamma, kappa
        self.base_lr = lr
        self.loss_skip_factor = loss_skip_factor
        self.seed = seed
        # epochs over which the graph and dihedral weights ramp 0 -> 1
        self.aux_warmup = aux_warmup
        # the excluded-volume hinge; its warm-up counts optimizer steps
        self.zeta = zeta
        self.steric_margin = steric_margin
        self.zeta_warmup = int(zeta_warmup or 0)
        # bond_project applies the rooted projection in training and
        # evaluation; bond_project_eval only to reconstructions and samples
        # (training through it can diverge: the JAX package's p7 run NaN'd
        # at epoch 30 of 300, examples/results/pcn_demo)
        self.bond_project = bool(bond_project)
        self.bond_project_eval = bool(bond_project_eval)
        self.tx = make_optimizer(grad_clip, "float32")

    def init_state(self) -> PCNTrainState:
        """Adam state for the model's current parameters."""
        params = dict(self.model.named_parameters())
        return PCNTrainState(params=params, opt_state=self.tx.init(list(params.values())),
                             step=0, lr=self.base_lr)

    def _inputs(self, batch: CGBatch, ca_mask, quads=None, quad_mask=None):
        """The batch and its arrays on the device."""
        def dev(a, dtype=None):
            return None if a is None else torch.as_tensor(a, dtype=dtype).to(self.device)

        return (batch.to(self.device), dev(ca_mask, torch.bool), dev(quads, torch.long),
                dev(quad_mask, torch.bool))

    def _project(self, xyz_recon: torch.Tensor, g: FlatGraph, ca_mask: torch.Tensor):
        return project_bonds_rooted(xyz_recon, g.xyz, g.bonds, g.bond_mask,
                                    ca_mask.reshape(-1), g.atom_mask)

    def _loss(self, batch: CGBatch, ca_mask, quads, quad_mask, aux_scale: float = 1.0,
              zeta: Optional[float] = None, generator: Optional[torch.Generator] = None):
        g = flatten_batch(batch)
        if self.stochastic:
            out = self.model(g, ca_mask, generator=generator)
        else:
            out = self.model(g, ca_mask)
        if self.bond_project:
            out.xyz_recon = self._project(out.xyz_recon, g, ca_mask)
        flat_quads = flatten_ids(quads, batch.n_atoms)            # (B*Q, 4)
        steric_batch = (batch.z, batch.bonds, batch.bond_mask) if self.zeta else None
        total, metrics = pcn_loss(
            out, g, flat_quads, quad_mask.reshape(-1), self.gamma, self.kappa, aux_scale,
            zeta=self.zeta if zeta is None else zeta, steric_batch=steric_batch,
            steric_margin=self.steric_margin)
        if self.stochastic and self.beta != 0.0:
            kl = kl_divergence(out.mu, out.sigma, out.prior_mu, out.prior_sigma, mask=g.cg_mask)
            total = total + self.beta * kl
            metrics.update(loss=total, kl=kl)
        return total, metrics

    def zeta_at(self, step: int) -> float:
        """The steric weight at ``step``: zeta * min(step / zeta_warmup, 1),
        in float32 as the JAX package computes it."""
        if self.zeta_warmup <= 0:
            return self.zeta
        f32 = np.float32
        return float(f32(self.zeta) * min(f32(step) / f32(self.zeta_warmup), f32(1.0)))

    def train_step(self, state: PCNTrainState, batch: CGBatch, ca_mask, quads, quad_mask,
                   aux_scale: float = 1.0) -> Tuple[PCNTrainState, Dict[str, torch.Tensor]]:
        """One guarded optimizer step on a host batch; metrics are detached
        0-d device tensors."""
        batch, ca_mask, quads, quad_mask = self._inputs(batch, ca_mask, quads, quad_mask)
        gen = (derived_generator(self.device, self.seed + 1, state.step)
               if self.stochastic else None)
        params = list(state.params.values())
        loss, metrics = self._loss(batch, ca_mask, quads, quad_mask, aux_scale,
                                   self.zeta_at(state.step), gen)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        thresh = self.gamma * self.loss_skip_factor if self.gamma > 0 else float("inf")
        opt_state, _ = guarded_update(self.tx, params, grads, loss.detach(), state.opt_state,
                                      state.lr, thresh)
        state = PCNTrainState(params=state.params, opt_state=opt_state,
                              step=state.step + 1, lr=state.lr)
        return state, {k: v.detach() for k, v in metrics.items()}

    def eval_step(self, batch: CGBatch, ca_mask, quads, quad_mask) -> Dict[str, torch.Tensor]:
        """The loss under the full objective (aux_scale 1, unramped zeta)."""
        batch, ca_mask, quads, quad_mask = self._inputs(batch, ca_mask, quads, quad_mask)
        gen = derived_generator(self.device, self.seed) if self.stochastic else None
        with torch.no_grad():
            _, metrics = self._loss(batch, ca_mask, quads, quad_mask, generator=gen)
        return metrics

    def reconstruct(self, batch: CGBatch, ca_mask) -> torch.Tensor:
        """(B*N, 3) reconstruction on the device: the posterior mean for
        StochasticPCN, projected under bond_project or bond_project_eval."""
        batch, ca_mask, _, _ = self._inputs(batch, ca_mask)
        with torch.inference_mode():
            g = flatten_batch(batch)
            if self.stochastic:
                xr = self.model.reconstruct_mean(g, ca_mask)
            else:
                xr = self.model(g, ca_mask).xyz_recon
            if self.bond_project or self.bond_project_eval:
                xr = self._project(xr, g, ca_mask)
        return xr

    def sample_ensemble(self, batch: CGBatch, ca_mask, k: int, seed: int = 0) -> torch.Tensor:
        """(K, B*N, 3) samples from the C-alpha trace (StochasticPCN only),
        sample i drawn from a generator seeded from (seed, i)."""
        if not self.stochastic:
            raise ValueError("sample_ensemble needs a StochasticPCN model")
        batch, ca_mask, _, _ = self._inputs(batch, ca_mask)
        g = flatten_batch(batch)
        out = []
        with torch.inference_mode():
            for i in range(k):
                xr = self.model.generate(g, ca_mask,
                                         generator=derived_generator(self.device, seed, i))
                if self.bond_project or self.bond_project_eval:
                    xr = self._project(xr, g, ca_mask)
                out.append(xr)
        return torch.stack(out)

    def run_epoch(self, state: PCNTrainState, dataset: PCNDatasetArrays, batch_size: int,
                  train: bool = True, shuffle_rng: Optional[np.random.Generator] = None,
                  aux_scale: float = 1.0) -> Tuple[PCNTrainState, Dict[str, float]]:
        """One pass over ``dataset``; the metrics' epoch means are read back
        once, at the end."""
        agg: Dict[str, list] = {}
        for batch, ca_mask, quads, quad_mask in dataset.iter_batches(
                batch_size, rng=shuffle_rng if train else None):
            if train:
                state, metrics = self.train_step(state, batch, ca_mask, quads, quad_mask,
                                                 aux_scale)
            else:
                metrics = self.eval_step(batch, ca_mask, quads, quad_mask)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        return state, {k: _mean(v) for k, v in agg.items()}

    def fit(self, state: PCNTrainState, trainset: PCNDatasetArrays, valset: PCNDatasetArrays,
            nepochs: int, batch_size: int, patience: int = 15, lr_patience: int = 2,
            lr_factor: float = 0.6, min_lr: float = 1e-8, log_fn=None):
        """Train with the LOWESS plateau LR and early stopping; returns the
        state holding the best validation epoch's parameters (a finite val
        loss, scored under the full objective from epoch 0), and the
        history rows with the JAX package's columns."""
        controller = LowessPlateauController(lr=self.base_lr, factor=lr_factor,
                                             patience=lr_patience, min_lr=min_lr)
        stopper = EarlyStopping(patience=patience)
        shuffle_rng = np.random.default_rng(self.seed)
        history = []
        best_val = np.inf
        # Adam renormalises clipped gradients, so a long run can turn
        # unstable late; test metrics come from the best validation epoch
        best = {k: p.detach().clone() for k, p in state.params.items()}
        steps_per_epoch = max(len(trainset) // max(batch_size, 1), 1)
        warm_epochs = max(int(self.aux_warmup or 0),
                          (-(-self.zeta_warmup // steps_per_epoch) if self.zeta else 0))
        for epoch in range(nepochs):
            t0 = time.time()
            aux = min(1.0, (epoch + 1) / self.aux_warmup) if self.aux_warmup > 0 else 1.0
            state, train_m = self.run_epoch(state, trainset, batch_size, train=True,
                                            shuffle_rng=shuffle_rng, aux_scale=aux)
            _, val_m = self.run_epoch(state, valset, batch_size, train=False)
            smoothed = controller.step(val_m["loss"]) if epoch >= warm_epochs else val_m["loss"]
            state.lr = controller.lr
            row = {
                "epoch": epoch, "lr": controller.lr,
                "train_loss": train_m["loss"], "val_loss": val_m["loss"],
                "train_recon": train_m["recon"], "val_recon": val_m["recon"],
                "train_graph": train_m["graph"], "val_graph": val_m["graph"],
                "train_dihe": train_m["dihe"], "val_dihe": val_m["dihe"],
                "epoch_time_s": time.time() - t0,
            }
            if "kl" in train_m:
                row["train_kl"] = train_m["kl"]
                row["val_kl"] = val_m.get("kl", float("nan"))
            history.append(row)
            if log_fn is not None:
                log_fn(row)
            if np.isfinite(val_m["loss"]) and val_m["loss"] < best_val:
                best_val = val_m["loss"]
                best = {k: p.detach().clone() for k, p in state.params.items()}
            if controller.converged:
                break
            if epoch >= warm_epochs:
                stopper(smoothed)
            if stopper.early_stop or not np.isfinite(val_m["recon"]):
                break
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(best[k])
        return state, history
