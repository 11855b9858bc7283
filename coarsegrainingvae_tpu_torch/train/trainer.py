"""Training: the optimiser, the train and eval steps, the epoch loops and
``fit`` (port of ``coarsegrainingvae_tpu.train.trainer``).

The step is the JAX package's: forward, ``vae_loss``, backward, the
skip-batch guard, a global-norm clip, then Adam with an injected learning
rate (utils.py:145-156 of the original code). PyTorch runs it eagerly, so
nothing is compiled and nothing is baked in: beta, gamma and the skip
threshold are read from ``Trainer.cfg`` at every step. On a CUDA device
every message layer runs a hand-written kernel forward and backward
(``ops.fused_message``, ``ops.fused_pseudo``).

Unlike the JAX package's pure functions, the step updates the model's
parameters in place (under ``torch.no_grad()``); ``TrainState.params``
holds references to them. The skip-batch guard stays on the device: a
rejected batch gives a zero update and leaves the moments and their step
count unchanged, chosen with ``torch.where`` and no host synchronisation.

``fit`` saves and resumes through ``train.checkpoint.CheckpointManager``.
Each epoch draws its noise from generators seeded from (seed, epoch), the
stand-in for the JAX package's ``fold_in(base_rng, epoch)``, so a resumed
run draws at epoch e what an uninterrupted one draws there.

Not ported yet (ROADMAP.md): the excluded-volume loss and its zeta_warmup
ramp (A8; ``zeta > 0`` raises), the epoch-as-one-program scan and the
streamed epoch (the device path here is a Python loop over index batches),
and the multi-device meshes.
"""
from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import ExperimentConfig
from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
from coarsegrainingvae_tpu_torch.models.cgvae import flatten_batch
from coarsegrainingvae_tpu_torch.train.controller import EarlyStopping, LowessPlateauController
from coarsegrainingvae_tpu_torch.train.losses import vae_loss
from coarsegrainingvae_tpu_torch.utils.rng import generator as derived_generator

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class AdamState:
    count: torch.Tensor   # () int32, accepted steps
    mu: torch.Tensor      # (P,) first moments of every parameter, flat, moment dtype
    nu: torch.Tensor      # (P,) second moments


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate tensors into one flat vector, in order."""
    return torch.cat([t.reshape(-1) for t in tensors])


def global_norm(flat: torch.Tensor) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.sqrt(torch.sum(flat * flat))


def clip_by_global_norm(flat: torch.Tensor, max_norm: float,
                        g_norm: torch.Tensor) -> torch.Tensor:
    """optax.clip_by_global_norm given the norm: g if norm < max, else
    g / norm * max (no epsilon, unlike torch.nn.utils.clip_grad_norm_)."""
    return torch.where(g_norm < max_norm, flat, (flat / g_norm) * max_norm)


class ScaleByAdamCompact:
    """Adam's scaling with both moments stored in ``moment_dtype`` and the
    update math in float32 (trainer.py:42-89 of the JAX package). At float32
    moments it is ``optax.scale_by_adam``.

    It works on the flat gradient of all parameters (``flatten``), so one
    step is a dozen elementwise launches over one vector, not a dozen per
    parameter tensor."""

    def __init__(self, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                 moment_dtype: torch.dtype = torch.bfloat16):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.moment_dtype = moment_dtype

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        n = sum(p.numel() for p in params)
        device = params[0].device

        def zeros():
            return torch.zeros(n, dtype=self.moment_dtype, device=device)

        return AdamState(count=torch.zeros((), dtype=torch.int32, device=device),
                         mu=zeros(), nu=zeros())

    def update(self, g: torch.Tensor, state: AdamState) -> Tuple[torch.Tensor, AdamState]:
        """(flat updates, new state); the state passed in is not modified."""
        b1, b2 = self.b1, self.b2
        count = state.count + 1
        c1 = 1.0 - b1 ** count.to(torch.float32)
        c2 = 1.0 - b2 ** count.to(torch.float32)
        m32 = b1 * state.mu.to(torch.float32) + (1.0 - b1) * g
        n32 = b2 * state.nu.to(torch.float32) + (1.0 - b2) * (g * g)
        upd = (m32 / c1) / (torch.sqrt(n32 / c2) + self.eps)
        return upd, AdamState(count=count, mu=m32.to(self.moment_dtype),
                              nu=n32.to(self.moment_dtype))


class ClippedAdam:
    """clip-by-global-norm, then Adam's scaling, on the flat gradient; the
    learning rate is applied by the step (``make_optimizer``,
    trainer.py:92-109)."""

    def __init__(self, grad_clip: float, adam: ScaleByAdamCompact):
        self.grad_clip, self.adam = grad_clip, adam

    def init(self, params: Sequence[torch.Tensor]) -> AdamState:
        return self.adam.init(params)

    def update(self, g: torch.Tensor, state: AdamState,
               g_norm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, AdamState]:
        if g_norm is None:
            g_norm = global_norm(g)
        return self.adam.update(clip_by_global_norm(g, self.grad_clip, g_norm), state)


def make_optimizer(grad_clip: float, moment_dtype: str = "float32") -> ClippedAdam:
    """Global-norm clip + Adam with both moments in ``moment_dtype``
    ("float32" or "bfloat16")."""
    return ClippedAdam(grad_clip, ScaleByAdamCompact(moment_dtype=_DTYPES[moment_dtype]))


@dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own, updated in place
    opt_state: AdamState
    step: torch.Tensor                      # () int64 on the device
    lr: torch.Tensor                        # () float32 on the device


def _mean(values: List[torch.Tensor]) -> float:
    return float(np.mean(torch.stack(values).float().cpu().numpy()))


class Trainer:
    """Train and eval steps, epoch loops and ``fit`` around one model on
    one device: the card unless the caller passes ``device="cpu"``. The
    model is moved there; without a card the default raises."""

    def __init__(self, model: torch.nn.Module, cfg: ExperimentConfig, device="cuda"):
        if cfg.train.zeta > 0:
            raise NotImplementedError(
                "the excluded-volume (steric) loss, zeta > 0, is not ported to "
                "PyTorch yet; see ROADMAP.md A8"
            )
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.tx = make_optimizer(cfg.train.grad_clip, cfg.train.adam_moment_dtype)

    # ------------------------------------------------------------------ init
    def init_state(self, batch: CGBatch) -> TrainState:
        """Optimizer state for the model's current parameters. ``batch``
        checks the channel lift: atom n reads vector channel
        channel_idx[n] of its bead, so every bead needs at most n_basis
        atoms."""
        max_ch = int(batch.channel_idx.max())
        n_basis = self.cfg.model.n_basis
        if max_ch >= n_basis:
            raise ValueError(
                f"largest CG bead has {max_ch + 1} atoms but n_basis="
                f"{n_basis}; the channel lift needs n_basis >= atoms-per-"
                f"bead -- raise n_basis or use more CG beads"
            )
        params = dict(self.model.named_parameters())
        return TrainState(
            params=params,
            opt_state=self.tx.init(list(params.values())),
            step=torch.zeros((), dtype=torch.long, device=self.device),
            lr=torch.tensor(self.cfg.train.lr, dtype=torch.float32, device=self.device),
        )

    def set_lr(self, state: TrainState, lr: float) -> TrainState:
        return dataclasses.replace(
            state, lr=torch.tensor(lr, dtype=torch.float32, device=self.device))

    # ----------------------------------------------------------------- steps
    def _loss_fn(self, batch: CGBatch, generator=None):
        tc = self.cfg.train
        out = self.model(batch, generator=generator)
        return vae_loss(out, flatten_batch(batch), tc.beta, tc.gamma,
                        h_bond_weight=tc.h_bond_weight, eta_h=tc.eta_h)

    def loss_and_grads(self, state: TrainState, batch: CGBatch,
                       generator: Optional[torch.Generator] = None):
        """(loss, metrics, gradients in ``state.params`` order) of one
        batch; metrics are detached 0-d device tensors."""
        params = list(state.params.values())
        loss, metrics = self._loss_fn(batch, generator)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def apply_gradients(self, state: TrainState, loss: torch.Tensor,
                        grads: Sequence[torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        """The guarded update: (new state, ok). The batch is accepted (ok)
        if its loss is finite and below gamma * loss_skip_factor and its
        gradient norm is finite; a rejected batch leaves the parameters,
        the moments and their count as they were."""
        tc = self.cfg.train
        params = list(state.params.values())
        with torch.no_grad():
            g = flatten(grads)
            g_norm = global_norm(g)
            thresh = tc.gamma * tc.loss_skip_factor if tc.gamma > 0 else math.inf
            ok = torch.isfinite(loss) & (loss < thresh) & torch.isfinite(g_norm)
            # a rejected batch's update and moments are discarded below with
            # torch.where, which passes over NaN and inf, so its gradient
            # need not be zeroed first
            upd, new_opt = self.tx.update(g, state.opt_state, g_norm)
            lr_eff = state.lr
            if tc.lr_warmup > 0:
                # (step+1)/N so the ramp starts at 1/N, not a wasted 0-step
                lr_eff = lr_eff * torch.clamp(
                    (state.step.to(torch.float32) + 1.0) / tc.lr_warmup, max=1.0)
            upd = torch.where(ok, -lr_eff * upd, 0.0)
            torch._foreach_add_(params, [u.view_as(p) for u, p in zip(
                torch.split(upd, [p.numel() for p in params]), params)])
            old = state.opt_state
            opt_state = AdamState(count=torch.where(ok, new_opt.count, old.count),
                                  mu=torch.where(ok, new_opt.mu, old.mu),
                                  nu=torch.where(ok, new_opt.nu, old.nu))
        return dataclasses.replace(state, opt_state=opt_state, step=state.step + 1), ok

    def train_step(self, state: TrainState, batch: CGBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (already on the device). Returns
        the new state and the step's metrics as 0-d device tensors."""
        loss, metrics, grads = self.loss_and_grads(state, batch, generator)
        state, ok = self.apply_gradients(state, loss, grads)
        scale = ok.to(torch.float32)
        metrics.update(skipped=1.0 - scale, grad_ok=scale)
        return state, metrics

    def eval_step(self, batch: CGBatch, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            _, metrics = self._loss_fn(batch, generator)
        return metrics

    def reconstruct(self, batch: CGBatch, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """(B*N, 3) reconstruction of ``batch`` through the posterior, on
        the device."""
        with torch.inference_mode():
            return self.model(batch.to(self.device), generator=generator).xyz_recon

    def generate(self, batch: CGBatch, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """(B*N, 3) coordinates drawn from the prior given the CG geometry
        of ``batch``, on the device."""
        with torch.inference_mode():
            return self.model.generate(batch.to(self.device), generator=generator)

    # ------------------------------------------------------------- epochs
    def _run_batches(self, state: TrainState, batches: Iterable[CGBatch],
                     generator: Optional[torch.Generator], train: bool
                     ) -> Tuple[TrainState, Dict[str, float]]:
        """Train or evaluate on each batch; the metrics' epoch means are
        read back once, at the end."""
        agg: Dict[str, list] = {}
        n_steps = 0
        for batch in batches:
            if train:
                state, metrics = self.train_step(state, batch, generator)
            else:
                metrics = self.eval_step(batch, generator)
            for k, v in metrics.items():
                agg.setdefault(k, []).append(v)
            n_steps += 1
        out = {k: _mean(v) for k, v in agg.items()}
        out["n_steps"] = n_steps
        return state, out

    def run_epoch_device(
        self, state: TrainState, dds: DeviceDataset,
        generator: Optional[torch.Generator] = None, train: bool = True,
        shuffle_rng: Optional[np.random.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Epoch over a DeviceDataset: the epoch's (S, B) frame indices go to
        the device once; each step gathers its batch there."""
        batches = epoch_index_batches(
            dds.n_frames, self.cfg.data.batch_size, shuffle_rng if train else None)
        idx = torch.as_tensor(batches, dtype=torch.long).to(self.device)
        return self._run_batches(state, (dds.gather(i) for i in idx), generator, train)

    def run_epoch(
        self, state: TrainState, dataset: CGDatasetArrays,
        generator: Optional[torch.Generator] = None, train: bool = True,
        shuffle_rng: Optional[np.random.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Epoch over host batches, each copied to the device."""
        batches = dataset.iter_batches(self.cfg.data.batch_size,
                                       rng=shuffle_rng if train else None)
        return self._run_batches(state, (b.to(self.device) for b in batches),
                                 generator, train)

    def fit(
        self, state: TrainState, trainset: CGDatasetArrays,
        valset: CGDatasetArrays,
        log_fn: Optional[Callable[[Dict[str, float]], None]] = None,
        nepochs: Optional[int] = None, ckpt=None, resume: bool = False,
        on_device: bool = True,
    ) -> Tuple[TrainState, list]:
        """Training run with the LOWESS plateau LR and early stopping;
        returns (final state, per-epoch history rows). on_device=True holds
        both splits on the device (DeviceDataset); False streams host
        batches.

        ckpt: an optional ``train.checkpoint.CheckpointManager``. The full
        train state is saved when the run stops, on the final epoch and
        every ``cfg.train.checkpoint_every`` epochs; resume=True restarts
        from its latest checkpoint (parameters copied into the model,
        moments, step, lr, controller and early-stop counters, history) at
        the next epoch. Epoch e draws its noise from generators seeded from
        (seed, e), as the JAX package folds e into its key; the shuffle
        order restarts from ``default_rng(seed)`` in every call, as the JAX
        package's does."""
        tc = self.cfg.train
        seed = self.cfg.data.seed
        controller = LowessPlateauController(
            lr=tc.lr, factor=tc.lr_factor, patience=tc.lr_patience,
            min_lr=tc.min_lr, frac=tc.lowess_frac,
        )
        stopper = EarlyStopping(patience=tc.patience)
        shuffle_rng = np.random.default_rng(seed)
        history = []
        start_epoch = 0
        n_epochs = nepochs if nepochs is not None else tc.nepochs
        # hold the plateau controller and the stopper while the lr warmup
        # ramps: the tracked loss moves because the objective moves
        steps_per_epoch = max(len(trainset) // max(self.cfg.data.batch_size, 1), 1)
        warm_epochs = -(-tc.lr_warmup // steps_per_epoch)

        dds_train = dds_val = None
        if on_device and trainset.aux_bonds is None:
            dds_train = DeviceDataset.from_dataset(trainset, self.device)
            dds_val = DeviceDataset.from_dataset(valset, self.device)

        if resume and ckpt is not None and ckpt.latest_step() is not None:
            state, meta, _ = ckpt.restore(state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            controller.load_state(meta.get("controller", {}))
            stopper.load_state(meta.get("stopper", {}))
            history = meta.get("history", [])
            state = self.set_lr(state, controller.lr)

        for epoch in range(start_epoch, n_epochs):
            t0 = time.time()
            train_gen = derived_generator(self.device, seed, epoch)
            val_gen = derived_generator(self.device, seed, epoch, 999)
            if dds_train is not None:
                state, train_m = self.run_epoch_device(
                    state, dds_train, train_gen, shuffle_rng=shuffle_rng)
                _, val_m = self.run_epoch_device(state, dds_val, val_gen, train=False)
            else:
                state, train_m = self.run_epoch(
                    state, trainset, train_gen, shuffle_rng=shuffle_rng)
                _, val_m = self.run_epoch(state, valset, val_gen, train=False)
            if epoch >= warm_epochs:
                smoothed = controller.step(val_m["loss"])
            else:
                smoothed = val_m["loss"]
            state = self.set_lr(state, controller.lr)
            # the effective end-of-epoch LR during an lr_warmup ramp
            lr_eff = controller.lr
            if tc.lr_warmup > 0:
                lr_eff *= min(((epoch + 1) * steps_per_epoch) / tc.lr_warmup, 1.0)
            row = {
                "epoch": epoch,
                "lr": lr_eff,
                "train_loss": train_m["loss"],
                "val_loss": val_m["loss"],
                "train_recon": train_m["recon"],
                "val_recon": val_m["recon"],
                "train_KL": train_m["kl"],
                "val_KL": val_m["kl"],
                "train_graph": train_m["graph"],
                "val_graph": val_m["graph"],
                "val_loss_smoothed": smoothed,
                "epoch_time_s": time.time() - t0,
            }
            history.append(row)
            if log_fn is not None:
                log_fn(row)

            if epoch >= warm_epochs:
                stopper(smoothed)
            # NaN abort (run_ala.py:278-281)
            stop = (controller.converged or stopper.early_stop
                    or not np.isfinite(val_m["recon"]))
            # save on stop, on the periodic schedule and always on the final
            # epoch, so a run that spends its epoch budget can be restored
            if ckpt is not None and (
                stop or epoch + 1 == n_epochs
                or (tc.checkpoint_every > 0 and (epoch + 1) % tc.checkpoint_every == 0)
            ):
                ckpt.save(epoch, state, metadata={
                    "epoch": epoch,
                    "controller": controller.save_state(),
                    "stopper": stopper.save_state(),
                    "history": history,
                })
            if stop:
                break
        return state, history
