"""DiffPoolVAE training (port of
``coarsegrainingvae_tpu.train.diffpool_trainer``; run_diffpool.py of the
original code).

The optimised loss is reg + recon + beta * KL (run_diffpool.py:186-210):

    reg    = mean over atoms of |x_i - (M cg_xyz)_i|^2   (atoms near their soft bead)
    recon  = coordinate MSE
    KL     = posterior against the conditional prior

The tracked ``loss`` (what the plateau controller reads) is recon + gamma *
graph + beta * KL; graph and entropy are metrics. The repo's extensions:
``graph_grad`` adds gamma * graph to the gradient, ramped in over
``graph_warmup`` steps; ``zeta`` adds the excluded-volume hinge, ramped
over ``zeta_warmup`` steps; ``h_project`` snaps the hydrogens of every
decoded frame onto their bond lengths. The gumbel temperature follows
``tau_schedule`` of the step counter.

The step is one eager call per batch, as in the JAX package: forward, loss,
backward, the finite-loss / finite-gradient guard, then Adam with float32
moments and no clip (``train.trainer.guarded_update`` with an infinite clip
and loss threshold). A rejected batch keeps the parameters and the moments;
``step`` advances all the same. ``pretrain`` regresses the soft assignment
onto a target mapping (run_diffpool.py:115-150) at tau_min, with no guard;
it advances Adam's count but not ``step``, so the tau schedule starts at 0
afterwards.

Noise: every train and eval step draws its gumbel noise, then its
reparametrisation noise, from a generator seeded from (seed, epoch, step)
(eval: (seed, epoch, 999, step)), the stand-ins for the JAX package's
``fold_in`` keys; ``noise`` is the one place that draws them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import DiffPoolConfig
from coarsegrainingvae_tpu_torch.data.diffpool import DiffPoolBatch, DiffPoolDatasetArrays
from coarsegrainingvae_tpu_torch.models.cgae import uniform_noise
from coarsegrainingvae_tpu_torch.models.cgvae import project_h_bonds
from coarsegrainingvae_tpu_torch.models.diffpool import DiffPoolOutput, DiffPoolVAE, tau_schedule
from coarsegrainingvae_tpu_torch.train.controller import EarlyStopping, LowessPlateauController
from coarsegrainingvae_tpu_torch.train.losses import kl_divergence, steric_active, steric_loss
from coarsegrainingvae_tpu_torch.train.trainer import (
    AdamState,
    add_updates_,
    flatten,
    guarded_update,
    make_optimizer,
)
from coarsegrainingvae_tpu_torch.utils.rng import generator as derived_generator

EPS = 1e-3


@dataclass
class DiffPoolTrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own, updated in place
    opt_state: AdamState
    step: int                               # global iteration (drives tau), skipped ones too
    lr: float


def _ramp(value: float, step: int, warmup: int):
    """value * min(step / warmup, 1) in float32, as a 0-d CPU tensor (a
    scalar argument to device ops, read on the host), or value itself
    when there is no warm-up."""
    if warmup <= 0:
        return value
    f32 = np.float32
    return torch.tensor(f32(value) * min(f32(step) / f32(warmup), f32(1.0)))


def diffpool_loss(out: DiffPoolOutput, bonds: torch.Tensor, beta: float, gamma: float,
                  zeta=0.0, steric=None, graph_grad: bool = False, gamma_grad=None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(optimised total, metrics). ``gamma_grad`` (a ramped weight) only
    enters the optimised total under ``graph_grad``; the tracked ``loss``
    keeps gamma * graph. The steric hinge counts when ``steric`` (thresh,
    pair_mask) is given and ``zeta`` is not a literal 0 (a ramped tensor
    always counts)."""
    xyz, xr, m = out.xyz, out.xyz_recon, out.assign
    anchor = torch.einsum("bkd,bnk->bnd", out.cg_xyz, m)
    loss_reg = torch.mean(torch.sum((anchor - xyz) ** 2, dim=-1))
    loss_recon = torch.mean((xr - xyz) ** 2)
    f = out.mu.shape[-1]
    loss_kl = kl_divergence(out.mu.reshape(-1, f), out.sigma.reshape(-1, f),
                            out.prior_mu.reshape(-1, f), out.prior_sigma.reshape(-1, f))
    loss_entropy = -torch.mean(torch.sum(m * torch.log(m + 1e-12), dim=-1))
    gen_d = torch.sqrt(torch.sum((xr[:, bonds[:, 0]] - xr[:, bonds[:, 1]]) ** 2, -1) + EPS)
    dat_d = torch.sqrt(torch.sum((xyz[:, bonds[:, 0]] - xyz[:, bonds[:, 1]]) ** 2, -1) + EPS)
    loss_graph = torch.mean((gen_d - dat_d) ** 2)

    total = loss_reg + loss_recon + beta * loss_kl
    if graph_grad:
        total = total + (gamma if gamma_grad is None else gamma_grad) * loss_graph
    metrics = {"loss": loss_recon + gamma * loss_graph + beta * loss_kl, "recon": loss_recon,
               "reg": loss_reg, "kl": loss_kl, "graph": loss_graph, "entropy": loss_entropy}
    if steric_active(zeta) and steric is not None:
        loss_steric = steric_loss(xr.reshape(-1, 3), steric[0], steric[1])
        total = total + zeta * loss_steric
        metrics["steric"] = loss_steric
    return total, metrics


def epoch_means(agg: Dict[str, list]) -> Dict[str, float]:
    """Each metric's mean over an epoch's steps, read back once, in sorted
    key order (the order of the JAX package's metric dicts)."""
    out = {}
    for k in sorted(agg):
        v = agg[k]
        arr = (torch.stack(v).float().cpu().numpy() if isinstance(v[0], torch.Tensor)
               else np.asarray(v, np.float32))
        out[k] = float(np.mean(arr))
    return out


class DiffPoolTrainer:
    """Train, eval and pretrain steps, sampling and ``fit`` for a
    ``DiffPoolVAE`` on one device: the card unless the caller passes
    ``device="cpu"``. The model is built from ``seed`` and moved there."""

    def __init__(self, cfg: DiffPoolConfig, beta: float = 0.05, gamma: float = 0.0,
                 lr: float = 1e-4, assign_idx: Optional[Sequence[int]] = None,
                 seed: int = 123, zeta: float = 0.0, steric_tables=None,
                 graph_grad: bool = False, zeta_warmup: int = 0, graph_warmup: int = 0,
                 h_project: bool = False, device="cuda"):
        self.device = torch.device(device)
        self.cfg = cfg
        self.beta, self.gamma, self.zeta = beta, gamma, zeta
        self.zeta_warmup = int(zeta_warmup or 0)
        self.graph_warmup = int(graph_warmup or 0)
        self.graph_grad = graph_grad
        self.h_project = bool(h_project)
        self.steric_tables = (
            tuple(torch.as_tensor(np.asarray(t)).to(self.device) for t in steric_tables)
            if steric_tables is not None else None)
        self.base_lr = lr
        self.seed = seed
        self.model = DiffPoolVAE(cfg, assign_idx,
                                 generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.tx = make_optimizer(float("inf"), "float32")

    def tau_at(self, step: int) -> float:
        c = self.cfg
        return tau_schedule(step, c.tau_0, c.tau_min, c.tau_rate)

    def init_state(self) -> DiffPoolTrainState:
        """Adam state for the model's current parameters, step 0."""
        params = dict(self.model.named_parameters())
        return DiffPoolTrainState(params=params, opt_state=self.tx.init(list(params.values())),
                                  step=0, lr=self.base_lr)

    def noise(self, key: Tuple[int, ...], batch_size: int
              ) -> Tuple[Optional[torch.Tensor], torch.Tensor]:
        """(u, eps) of one call, drawn from the generator of ``key``: the
        pooler's uniform draw (None for a fixed mapping), then the
        (B, K, F) normal draw."""
        gen = derived_generator(self.device, *key)
        shape = self.model.pooler.noise_shape(batch_size, self.cfg.n_atoms)
        u = None if shape is None else uniform_noise(shape, gen, self.device)
        eps = torch.randn((batch_size, self.cfg.n_cgs, self.cfg.feat_dim), generator=gen,
                          device=self.device)
        return u, eps

    def project(self, xyz_recon: torch.Tensor, z: torch.Tensor, xyz_true: torch.Tensor,
                bonds: torch.Tensor) -> torch.Tensor:
        """The H bond-length projection of every (B, N, 3) frame, over the
        flattened batch (one shared topology; ``bonds`` may be the
        high-order edge list: each H keeps its nearest heavy partner)."""
        b, n, _ = xyz_recon.shape
        offsets = torch.arange(b, device=bonds.device)[:, None, None] * n
        flat_bonds = (bonds[None] + offsets).reshape(-1, 2)
        return project_h_bonds(xyz_recon.reshape(-1, 3), z.reshape(-1),
                               xyz_true.reshape(-1, 3), flat_bonds, None).reshape(b, n, 3)

    def apply(self, batch: DiffPoolBatch, tau, u, eps) -> DiffPoolOutput:
        out = self.model(batch.z, batch.xyz, batch.adj, tau, u=u, eps=eps)
        if self.h_project:
            out.xyz_recon = self.project(out.xyz_recon, batch.z, out.xyz, batch.bonds)
        return out

    def loss(self, batch: DiffPoolBatch, step: int, key: Tuple[int, ...], train: bool = True
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(optimised total, metrics) of a device batch at ``step``: the
        training objective (ramped zeta and graph weight) or, with
        ``train=False``, the eval step's (unramped zeta)."""
        u, eps = self.noise(key, batch.xyz.shape[0])
        out = self.apply(batch, self.tau_at(step), u, eps)
        if train:
            zeta = _ramp(self.zeta, step, self.zeta_warmup)
            gamma_grad = (_ramp(self.gamma, step, self.graph_warmup)
                          if self.graph_warmup > 0 else None)
        else:
            zeta, gamma_grad = self.zeta, None
        return diffpool_loss(out, batch.bonds, self.beta, self.gamma, zeta=zeta,
                             steric=self.steric_tables, graph_grad=self.graph_grad,
                             gamma_grad=gamma_grad)

    def train_step(self, state: DiffPoolTrainState, batch: DiffPoolBatch,
                   key: Tuple[int, ...]) -> Tuple[DiffPoolTrainState, Dict[str, torch.Tensor]]:
        """One guarded Adam step on a host batch; metrics are detached 0-d
        device tensors, with ``tau`` a float."""
        batch = batch.to(self.device)
        params = list(state.params.values())
        total, metrics = self.loss(batch, state.step, key)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        opt_state, _ = guarded_update(self.tx, params, grads, metrics["loss"].detach(),
                                      state.opt_state, state.lr, float("inf"))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["tau"] = self.tau_at(state.step)
        return DiffPoolTrainState(params=state.params, opt_state=opt_state, step=state.step + 1,
                                  lr=state.lr), metrics

    def eval_step(self, batch: DiffPoolBatch, key: Tuple[int, ...],
                  step: int) -> Dict[str, torch.Tensor]:
        """The metrics of a host batch, with gumbel noise at the tau of
        ``step`` and the unramped zeta."""
        with torch.no_grad():
            _, metrics = self.loss(batch.to(self.device), step, key, train=False)
        return metrics

    def pretrain_step(self, state: DiffPoolTrainState, batch: DiffPoolBatch,
                      key: Tuple[int, ...], target: torch.Tensor
                      ) -> Tuple[DiffPoolTrainState, torch.Tensor]:
        """Adam on mean (M - target)^2 at tau_min, unguarded; only the
        pooler reaches the assignment, so only it is run, and every other
        parameter gets the zero gradient it has in the JAX package."""
        batch = batch.to(self.device)
        params = list(state.params.values())
        u, _ = self.noise(key, batch.xyz.shape[0])
        xyz = batch.xyz - torch.mean(batch.xyz, dim=1, keepdim=True)
        pool = self.model.pooler(batch.z, xyz, batch.adj, self._tau_min(), u=u)
        loss = torch.mean((pool.assign - target[None]) ** 2)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        with torch.no_grad():
            g = flatten([torch.zeros_like(p) if d is None else d for p, d in zip(params, grads)])
            upd, opt_state = self.tx.update(g, state.opt_state)
            add_updates_(params, [(-state.lr * d).view_as(p) for d, p in zip(
                torch.split(upd, [p.numel() for p in params]), params)])
        return DiffPoolTrainState(params=state.params, opt_state=opt_state, step=state.step,
                                  lr=state.lr), loss.detach()

    def _tau_min(self) -> float:
        return float(np.float32(self.cfg.tau_min))

    def pretrain(self, state: DiffPoolTrainState, dataset: DiffPoolDatasetArrays,
                 target_mapping: np.ndarray, n_epochs: int, batch_size: int
                 ) -> Tuple[DiffPoolTrainState, float]:
        """``n_epochs`` shuffled passes of ``pretrain_step``; returns the
        last epoch's mean loss."""
        target = torch.nn.functional.one_hot(
            torch.as_tensor(np.asarray(target_mapping, np.int64)), self.cfg.n_cgs
        ).float().to(self.device)
        shuffle = np.random.default_rng(self.seed)
        loss = float("nan")
        for ep in range(n_epochs):
            losses = []
            for i, batch in enumerate(dataset.iter_batches(batch_size, rng=shuffle)):
                state, l = self.pretrain_step(state, batch, (self.seed + 17, ep * 10000 + i),
                                              target)
                losses.append(l)
            loss = epoch_means({"loss": losses})["loss"]
        return state, loss

    def sample(self, batch: DiffPoolBatch, seed: int, hard: bool = False) -> torch.Tensor:
        """(B, N, 3) samples from the conditional prior at tau_min (hard:
        the argmax assignment), projected under ``h_project``."""
        batch = batch.to(self.device)
        u, eps = self.noise((seed,), batch.xyz.shape[0])
        with torch.no_grad():
            xs = self.model.sample(batch.z, batch.xyz, batch.adj, self._tau_min(),
                                   hard=hard, u=u, eps=eps)
            if self.h_project:
                xs = self.project(xs, batch.z, batch.xyz, batch.bonds)
        return xs

    def run_epoch(self, state: DiffPoolTrainState, dataset: DiffPoolDatasetArrays,
                  key: Tuple[int, ...], batch_size: int, train: bool = True,
                  shuffle_rng: Optional[np.random.Generator] = None
                  ) -> Tuple[DiffPoolTrainState, Dict[str, float]]:
        """One pass; step i draws its noise from (*key, i). The metrics'
        means are read back once, at the end."""
        agg: Dict[str, list] = {}
        for i, batch in enumerate(dataset.iter_batches(batch_size,
                                                       rng=shuffle_rng if train else None)):
            if train:
                state, metrics = self.train_step(state, batch, (*key, i))
            else:
                metrics = self.eval_step(batch, (*key, i), state.step)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
        return state, epoch_means(agg)

    def fit(self, state: DiffPoolTrainState, trainset: DiffPoolDatasetArrays,
            valset: DiffPoolDatasetArrays, nepochs: int, batch_size: int, patience: int = 20,
            lr_patience: int = 10, lr_factor: float = 0.6, min_lr: float = 1e-8, log_fn=None):
        """Train with the LOWESS plateau LR and early stopping. While a
        warm-up ramp is active the tracked loss moves because the
        objective moves, so the controller and the stopper hold until
        every active ramp (zeta with steric tables, the graph weight under
        graph_grad) has ended."""
        controller = LowessPlateauController(lr=self.base_lr, factor=lr_factor,
                                             patience=lr_patience, min_lr=min_lr)
        stopper = EarlyStopping(patience=patience)
        shuffle_rng = np.random.default_rng(self.seed)
        steps_per_epoch = max(len(trainset) // batch_size, 1)
        warm_steps = max(self.zeta_warmup if (self.zeta and self.steric_tables) else 0,
                         self.graph_warmup if self.graph_grad else 0)
        warm_epochs = -(-warm_steps // steps_per_epoch) if warm_steps else 0
        history = []
        for epoch in range(nepochs):
            t0 = time.time()
            state, train_m = self.run_epoch(state, trainset, (self.seed, epoch), batch_size,
                                            train=True, shuffle_rng=shuffle_rng)
            _, val_m = self.run_epoch(state, valset, (self.seed, epoch, 999), batch_size,
                                      train=False)
            smoothed = controller.step(val_m["loss"]) if epoch >= warm_epochs else val_m["loss"]
            state.lr = controller.lr
            row = {
                "epoch": epoch, "lr": controller.lr,
                "train_loss": train_m["loss"], "val_loss": val_m["loss"],
                "train_recon": train_m["recon"], "val_recon": val_m["recon"],
                "train_KL": train_m["kl"], "val_KL": val_m["kl"],
                "train_graph": train_m["graph"], "val_graph": val_m["graph"],
                "tau": train_m["tau"], "epoch_time_s": time.time() - t0,
            }
            history.append(row)
            if log_fn is not None:
                log_fn(row)
            if controller.converged:
                break
            if epoch >= warm_epochs:
                stopper(smoothed)
            if stopper.early_stop or not np.isfinite(val_m["recon"]):
                break
        return state, history
