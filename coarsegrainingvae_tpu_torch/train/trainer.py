"""Training: the optimiser, the train and eval steps, the epoch loops and
``fit`` (port of ``coarsegrainingvae_tpu.train.trainer``).

The step is the JAX package's: forward, ``vae_loss``, backward, the
skip-batch guard, a global-norm clip, then Adam with an injected learning
rate (utils.py:145-156 of the original code). Beta, gamma and the skip
threshold are read from ``Trainer.cfg`` at every step. On a CUDA device
every message layer runs a hand-written kernel forward and backward
(``ops.fused_message``, ``ops.fused_pseudo``).

Unlike the JAX package's pure functions, the step updates the model's
parameters in place (under ``torch.no_grad()``); ``TrainState.params``
holds references to them. The skip-batch guard stays on the device: a
rejected batch gives a zero update and leaves the moments and their step
count unchanged, chosen with ``torch.where`` and no host synchronisation.

The device-resident epoch (``run_epoch_scan``, ``run_epoch_scan_eval``,
``run_epoch_streamed``; the JAX package's epoch as one ``lax.scan``) runs a
step written against static buffers (``_EpochProgram``): it gathers its
batch from a device index table at a device step counter and writes the
optimizer state and its metrics into tensors whose addresses never change.
On a CUDA device one train step and one eval step are captured as CUDA
graphs and replayed S times per epoch, with no Python per step; a capture
that fails raises. On the CPU the same step runs in a Python loop. ``fit``
takes that path for data held on the device and frees the graphs when it
returns; ``train_step`` / ``eval_step`` stay the eager API.

``fit`` saves and resumes through ``train.checkpoint.CheckpointManager``.
Each epoch draws its noise from generators seeded from (seed, epoch), the
stand-in for the JAX package's ``fold_in(base_rng, epoch)``, so a resumed
run draws at epoch e what an uninterrupted one draws there.

With ``zeta > 0`` and the tables of ``losses.build_steric_tables`` the
loss carries the excluded-volume term. The tables live on the device and
the captured step reads them in place; the ``zeta_warmup`` ramp, zeta *
min(step / warmup, 1), reads the device step counter, so no Python number
enters the captured step. ``reconstruct`` and ``generate`` apply the H
bond-length projection when ``cfg.model.h_project_eval``. The model is the
dense ``DenseCGVAE`` or the sparse ``CGequiVAE``; both are captured alike.

Data parallelism (``parallel.mesh``; the JAX package's sharded global-batch
step): with a process group, every rank receives the global batch and
trains on its own rows (all of them when the batch does not divide by the
world size). Its noise is its rows of the global batch's draw
(``RowNoise``), each loss term is its rows' sum over the global batch's
count (``losses.loss_denominators``), and one flat buffer of [gradient,
loss, metrics] is all-reduced per step and divided by the world size, so
the skip-batch guard decides from the global values on every rank.
Parameters start from rank 0's (``replicate``). With
``cfg.parallel.zero_optimizer`` and more than one rank (ZeRO-1) each rank
holds the moments of its slice of the flat parameter vector, runs clip and
Adam there with the global gradient norm, and all-gathers the update. On
NCCL the collectives are captured in the epoch's CUDA graph; gloo ranks
run the same static step in a Python loop (gloo stages CUDA tensors
through the host, which a graph cannot hold).

Tensor parallelism (``cfg.parallel.model_devices`` = m > 1, a (n / m, m)
('data', 'model') mesh; ``parallel.tensor``): the rows are split over the
data axis only, so the m ranks of a model group train on the same rows with
the same noise. Each model rank holds the moments of its 1/m shard of every
tensor the JAX package's ``tensor_shardings`` shards (and the whole of every
other), and the gathered parameters the model computes with. In the dense
model the message blocks run kernels 1-4 on the rank's F/m features and
gather their outputs (``split_messages``); everything else computes on the
gathered weights, alike on every rank of the group. Per step the partial
gradients of the split blocks' phi_out and filter_w are all-reduced over the
model group, the rank's local gradient (its shards, and the replicated
tensors whole) with the loss and metrics over the data group, the clip reads
the global norm (the shards' squares summed over the model group), Adam
updates the local part, and the shards' updates are all-gathered over the
model group into every parameter. ZeRO-1 is off under tensor parallelism, as
in the JAX package. Checkpoints hold the one-process form (moments gathered).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import ExperimentConfig
from coarsegrainingvae_tpu_torch.convert import tensor_layouts
from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
from coarsegrainingvae_tpu_torch.models.cgvae import flatten_batch, project_batch_h_bonds
from coarsegrainingvae_tpu_torch.ops import kernel_counters
from coarsegrainingvae_tpu_torch.parallel.mesh import (
    Mesh,
    RowNoise,
    all_gather_,
    all_reduce_,
    make_mesh,
    replicate,
    shard_rows,
    zero_partition,
)
from coarsegrainingvae_tpu_torch.parallel.tensor import TensorLayout, split_messages
from coarsegrainingvae_tpu_torch.train.controller import EarlyStopping, LowessPlateauController
from coarsegrainingvae_tpu_torch.train.losses import loss_denominators, vae_loss
from coarsegrainingvae_tpu_torch.utils.rng import generator as derived_generator

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclass
class AdamState:
    count: torch.Tensor   # () int32, accepted steps
    mu: torch.Tensor      # (P,) first moments of every parameter, flat, moment dtype
    nu: torch.Tensor      # (P,) second moments


def flatten(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """Concatenate tensors into one flat vector, in order, in their promoted
    dtype. The few bf16 ones are cast first: a cat over mixed dtypes copies
    its inputs one launch each."""
    dtype = functools.reduce(torch.promote_types, (t.dtype for t in tensors))
    return torch.cat([t.reshape(-1).to(dtype) for t in tensors])


def add_updates_(params: Sequence[torch.Tensor], updates: Sequence[torch.Tensor]) -> None:
    """params[i] += updates[i], in place. Parameters of the updates' dtype
    take one foreach launch; the others (the compute-dtype filters, which
    the JAX package keeps in bf16 at bf16 compute) one add each, computed
    in float32 and rounded once to the parameter's dtype, as
    ``optax.apply_updates`` does. One foreach over mixed dtypes would fall
    back to a launch per parameter."""
    same = [(p, u) for p, u in zip(params, updates) if p.dtype == u.dtype]
    if same:
        torch._foreach_add_([p for p, _ in same], [u for _, u in same])
    for p, u in zip(params, updates):
        if p.dtype != u.dtype:
            p.add_(u)


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

    def init(self, params: Sequence[torch.Tensor], numel: Optional[int] = None) -> AdamState:
        """Zero moments for ``params``, or for ``numel`` entries of them
        (a ZeRO-1 slice)."""
        n = sum(p.numel() for p in params) if numel is None else numel
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

    def init(self, params: Sequence[torch.Tensor], numel: Optional[int] = None) -> AdamState:
        return self.adam.init(params, numel)

    def update(self, g: torch.Tensor, state: AdamState,
               g_norm: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, AdamState]:
        if g_norm is None:
            g_norm = global_norm(g)
        return self.adam.update(clip_by_global_norm(g, self.grad_clip, g_norm), state)


def make_optimizer(grad_clip: float, moment_dtype: str = "float32") -> ClippedAdam:
    """Global-norm clip + Adam with both moments in ``moment_dtype``
    ("float32" or "bfloat16")."""
    return ClippedAdam(grad_clip, ScaleByAdamCompact(moment_dtype=_DTYPES[moment_dtype]))


def guarded_update(tx: ClippedAdam, params: Sequence[torch.Tensor],
                   grads: Sequence[torch.Tensor], loss: torch.Tensor, opt_state: AdamState,
                   lr, thresh: float) -> Tuple[AdamState, torch.Tensor]:
    """The skip-batch guard around one clipped Adam step, on the device:
    the batch is accepted (ok) if its loss is finite and below ``thresh``
    and its gradient norm is finite. An accepted batch moves ``params`` in
    place by -lr * update and gives the new moments; a rejected one leaves
    the parameters, the moments and their count as they were. Returns
    (moments, ok), with no host synchronisation."""
    with torch.no_grad():
        return guarded_update_flat(tx, params, flatten(grads), loss, opt_state, lr, thresh)


def guarded_update_flat(tx: ClippedAdam, params: Sequence[torch.Tensor], g: torch.Tensor,
                        loss: torch.Tensor, opt_state: AdamState, lr, thresh: float,
                        zero: Optional[Tuple[Mesh, slice, int]] = None,
                        tensor: Optional[TensorLayout] = None
                        ) -> Tuple[AdamState, torch.Tensor]:
    """``guarded_update`` on the flat gradient ``g``. ``zero`` = (mesh,
    this rank's slice, padded length) of ``zero_partition``: ZeRO-1, where
    ``opt_state`` holds the moments of this rank's slice only, clip and
    Adam run there with the norm of the whole ``g``, and the update is
    all-gathered over the mesh. ``tensor``: tensor parallelism, where ``g``
    and ``opt_state`` are this model rank's local part (``TensorLayout``),
    the norm is the whole gradient's and the shards' updates are gathered
    over the model group."""
    with torch.no_grad():
        g_norm = global_norm(g) if tensor is None else torch.sqrt(tensor.sq_norm(g))
        ok = torch.isfinite(loss) & (loss < thresh) & torch.isfinite(g_norm)
        # a rejected batch's update and moments are discarded below with
        # torch.where, which passes over NaN and inf, so its gradient
        # need not be zeroed first
        if zero is None:
            upd, new_opt = tx.update(g, opt_state, g_norm)
            upd = torch.where(ok, -lr * upd, 0.0)
        else:
            mesh, part, padded = zero
            g_part = torch.nn.functional.pad(g, (0, padded - g.numel()))[part]
            upd, new_opt = tx.update(g_part, opt_state, g_norm)
            upd = all_gather_(torch.empty(padded, dtype=g.dtype, device=g.device),
                              torch.where(ok, -lr * upd, 0.0), mesh)[:g.numel()]
        if tensor is not None:
            add_updates_(params, tensor.expand(upd))
        else:
            add_updates_(params, [u.view_as(p) for u, p in zip(
                torch.split(upd, [p.numel() for p in params]), params)])
        opt_state = AdamState(count=torch.where(ok, new_opt.count, opt_state.count),
                              mu=torch.where(ok, new_opt.mu, opt_state.mu),
                              nu=torch.where(ok, new_opt.nu, opt_state.nu))
    return opt_state, ok


@dataclass
class TrainState:
    params: Dict[str, torch.nn.Parameter]   # the model's own, updated in place
    opt_state: AdamState
    step: torch.Tensor                      # () int64 on the device
    lr: torch.Tensor                        # () float32 on the device


def _mean(values: List[torch.Tensor]) -> float:
    return float(np.mean(torch.stack(values).float().cpu().numpy()))


# the per-frame arrays run_epoch_streamed copies into its chunk buffers
STREAMED_FIELDS = ("xyz", "cg_xyz", "nbrs", "nbr_mask", "cg_nbrs", "cg_nbr_mask")

# eager steps on a side stream before a capture: the lazy set-up (kernel
# builds and their shared-memory limits, cuBLAS handles and workspaces,
# autograd's device threads) happens there, not inside the capture
WARMUP_STEPS = 3


def _step_tensors(state: TrainState) -> tuple:
    """The tensors a train step replaces: the moments, their count, the step."""
    return (state.opt_state.count, state.opt_state.mu, state.opt_state.nu, state.step)


class _EpochProgram:
    """One train or eval step over one DeviceDataset, written against
    static buffers: the (S_max, B) index table, the step counter, the
    (S_max, k) metrics buffer and, for training, the optimizer state, step
    and lr of ``state``, all updated in place. On a CUDA device the step is
    captured once as a CUDA graph and replayed; its noise comes from a
    generator registered with the graph, loaded from the caller's before
    the replays and copied back after them."""

    def __init__(self, trainer: "Trainer", dds: DeviceDataset, train: bool, max_steps: int):
        device = trainer.device
        self.trainer, self.dds, self.train = trainer, dds, train
        self.table = torch.zeros((max_steps, trainer.cfg.data.batch_size), dtype=torch.long,
                                 device=device)
        self.counter = torch.zeros((), dtype=torch.long, device=device)
        self.keys: Optional[List[str]] = None
        self.metrics: Optional[torch.Tensor] = None
        self.state: Optional[TrainState] = None
        self.graph = None
        self.graph_generator: Optional[torch.Generator] = None
        self.launches: Optional[List[int]] = None     # per replay, counted at capture
        self._generator: Optional[torch.Generator] = None

    def step(self) -> None:
        """One step at row ``counter`` of the table; no host synchronisation."""
        idx = self.table.index_select(0, self.counter.view(1)).view(-1)
        batch = self.dds.gather(idx)
        tr = self.trainer
        if self.train:
            new, metrics = tr.train_step(self.state, batch, self._generator)
            with torch.no_grad():
                for static, value in zip(_step_tensors(self.state), _step_tensors(new)):
                    static.copy_(value)
        else:
            metrics = tr.eval_step(batch, self._generator)
        with torch.no_grad():
            if self.metrics is None:
                self.keys = list(metrics)
                self.metrics = torch.zeros((self.table.shape[0], len(self.keys)),
                                           dtype=torch.float32, device=tr.device)
            row = torch.stack([metrics[k].float() for k in self.keys])
            self.metrics.index_copy_(0, self.counter.view(1), row.view(1, -1))
            self.counter.add_(1)

    def _adopt(self, state: TrainState) -> None:
        """Make ``state``'s optimizer tensors the static ones, or copy them in."""
        if self.state is None:
            self.state = state
            return
        with torch.no_grad():
            for a, b in zip((*_step_tensors(self.state), self.state.lr),
                            (*_step_tensors(state), state.lr)):
                if a is not b:
                    a.copy_(b)

    def _capture(self, source: torch.Generator) -> None:
        """Warm up on a side stream, capture one step, then undo the
        warm-up: parameters, moments and step as they were, the kernels'
        launch counts as they were. A replay adds the counts of the capture
        to them."""
        device = self.trainer.device
        if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            raise RuntimeError("this PyTorch lacks CUDAGraph.register_generator_state; the "
                               "captured epoch needs a generator registered with its graph")
        gen = torch.Generator(device=device)
        gen.set_state(source.get_state())
        self._generator = gen
        counters = kernel_counters()
        before = [fn.launches for fn in counters]
        changed = (*self.state.params.values(), *_step_tensors(self.state)) if self.train else ()
        saved = [t.detach().clone() for t in changed]
        side = torch.cuda.Stream(device)
        side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            for _ in range(WARMUP_STEPS):
                self.counter.zero_()
                self.step()
        torch.cuda.current_stream(device).wait_stream(side)
        self.counter.zero_()
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(gen)
        counts = [fn.launches for fn in counters]
        with torch.cuda.graph(graph):
            self.step()
        self.launches = [fn.launches - c for fn, c in zip(counters, counts)]
        for fn, n in zip(counters, before):
            fn.launches = n
        with torch.no_grad():
            for t, v in zip(changed, saved):
                t.copy_(v)
        self.graph, self.graph_generator = graph, gen

    def run(self, state: Optional[TrainState], batches: np.ndarray,
            generator: Optional[torch.Generator], capture: bool) -> Dict[str, float]:
        """S steps over ``batches`` (S, B): replays of the captured step when
        ``capture``, else the step in a Python loop. Returns the metrics'
        epoch means, read back once."""
        n_steps = batches.shape[0]
        if n_steps > self.table.shape[0]:
            raise ValueError(f"{n_steps} steps, the program holds {self.table.shape[0]}")
        if self.train:
            self._adopt(state)
        self.table[:n_steps].copy_(torch.as_tensor(batches, dtype=torch.long))
        self.counter.zero_()
        if not capture:
            self._generator = generator
            for _ in range(n_steps):
                self.step()
        else:
            device = self.trainer.device
            source = generator if generator is not None else \
                torch.cuda.default_generators[device.index or 0]
            if self.graph is None:
                self._capture(source)
            self.graph_generator.set_state(source.get_state())
            counters = kernel_counters()
            for _ in range(n_steps):
                self.graph.replay()
                for fn, n in zip(counters, self.launches):
                    fn.launches += n
            source.set_state(self.graph_generator.get_state())
        host = self.metrics[:n_steps].cpu().numpy()
        out = {k: float(np.mean(np.ascontiguousarray(host[:, j])))
               for j, k in enumerate(self.keys)}
        out["n_steps"] = n_steps
        return out

    def release(self) -> None:
        if self.graph is not None:
            self.graph.reset()
        self.graph = self.graph_generator = None


class Trainer:
    """Train and eval steps, epoch loops and ``fit`` around one model on
    one device: the card unless the caller passes ``device="cpu"``. The
    model is moved there; without a card the default raises.

    steric_tables: (thresh (N, N), pair_mask (N, N)) from
    ``losses.build_steric_tables``, used when ``cfg.train.zeta`` is not 0;
    copied to the device once, where the steps read them.

    mesh: the mesh (``parallel.mesh.make_mesh``); None takes
    ``make_mesh(cfg.parallel.num_devices, cfg.parallel.model_devices)``,
    which is every rank of an initialised process group and otherwise this
    process alone. A mesh with a process group trains data-parallel, and
    tensor-parallel over its model axis when it has one (module
    docstring); without one every path is the single-device one."""

    def __init__(self, model: torch.nn.Module, cfg: ExperimentConfig, device="cuda",
                 steric_tables=None, mesh: Optional[Mesh] = None):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.cfg = cfg
        self.steric_tables = None if steric_tables is None else tuple(
            torch.as_tensor(np.asarray(t)).to(self.device) for t in steric_tables)
        self.mesh = mesh if mesh is not None else make_mesh(
            cfg.parallel.num_devices, cfg.parallel.model_devices, device=self.device)
        # ZeRO-1: (mesh, this rank's slice, padded length), set by init_state
        self._zero: Optional[Tuple[Mesh, slice, int]] = None
        # tensor parallelism: this model rank's part of the optimizer state,
        # and (by parameter index) the parameters whose gradients are partial
        # on each rank
        self._tensor: Optional[TensorLayout] = None
        self._partial: List[int] = []
        if self.mesh.model_size > 1:
            shapes = {n: p.shape for n, p in self.model.named_parameters()}
            self._tensor = TensorLayout(list(shapes.items()),
                                        tensor_layouts(shapes, cfg.model), self.mesh.model_axis)
            names = list(shapes)
            self._partial = [names.index(n) for n in split_messages(self.model,
                                                                    self.mesh.model_axis)]
        self.tx = make_optimizer(cfg.train.grad_clip, cfg.train.adam_moment_dtype)
        # static-buffer epoch programs by (DeviceDataset, train), and the two
        # chunk buffers of run_epoch_streamed; release_graphs frees them
        self._programs: Dict[Tuple[int, bool], _EpochProgram] = {}
        self._stream_buffers = None

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
        numel = None
        if self.mesh.group is not None:
            replicate(list(params.values()), self.mesh)
            if self._tensor is not None:
                numel = self._tensor.numel
            elif self.cfg.parallel.zero_optimizer and self.mesh.size > 1:
                part, padded = zero_partition(sum(p.numel() for p in params.values()),
                                              self.mesh)
                self._zero = (self.mesh, part, padded)
                numel = part.stop - part.start
        return TrainState(
            params=params,
            opt_state=self.tx.init(list(params.values()), numel),
            step=torch.zeros((), dtype=torch.long, device=self.device),
            lr=torch.tensor(self.cfg.train.lr, dtype=torch.float32, device=self.device),
        )

    def set_lr(self, state: TrainState, lr: float) -> TrainState:
        """Write ``lr`` into the state's device scalar, in place: a captured
        step reads it at that address."""
        with torch.no_grad():
            state.lr.fill_(lr)
        return state

    # ----------------------------------------------------------------- steps
    def _loss_fn(self, batch: CGBatch, generator=None, zeta_scale=None, denominators=None):
        tc = self.cfg.train
        out = self.model(batch, generator=generator)
        zeta = tc.zeta if zeta_scale is None else tc.zeta * zeta_scale
        return vae_loss(out, flatten_batch(batch), tc.beta, tc.gamma, zeta=zeta,
                        steric=self.steric_tables, h_bond_weight=tc.h_bond_weight,
                        eta_h=tc.eta_h, denominators=denominators)

    def _shard(self, batch: CGBatch, generator):
        """(this rank's rows of the global ``batch``, the stand-in for
        ``generator`` that draws their noise, the loss denominators of the
        global batch); the batch itself, the generator and None when every
        rank computes every row."""
        n = batch.z.shape[0]
        rows = shard_rows(n, self.mesh)
        if rows.stop - rows.start == n:
            return batch, generator, None
        tc = self.cfg.train
        den = loss_denominators(flatten_batch(batch), n, tc.gamma, self.steric_tables,
                                tc.h_bond_weight, tc.eta_h, shards=self.mesh.data_axis.size)
        local = CGBatch(**{f.name: None if getattr(batch, f.name) is None
                           else getattr(batch, f.name)[rows]
                           for f in dataclasses.fields(batch)})
        return local, RowNoise(generator, n, rows), den

    def _all_reduce(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The mean over the mesh's data axis of ``parts`` concatenated flat
        in f32: one collective."""
        data = self.mesh.data_axis
        buf = torch.cat([t.reshape(-1).to(torch.float32) for t in parts])
        return all_reduce_(buf, data) / data.size

    def _local_gradient(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """Under tensor parallelism: the partial gradients of the split
        message blocks summed over the model group (one collective), then
        this model rank's local part, flat in f32."""
        if self._partial:
            idx = self._partial
            summed = all_reduce_(flatten([grads[i].to(torch.float32) for i in idx]),
                                 self.mesh.model_axis)
            grads = list(grads)
            for i, part in zip(idx, torch.split(summed, [grads[i].numel() for i in idx])):
                grads[i] = part.view(grads[i].shape)
        return self._tensor.local([g.to(torch.float32) for g in grads])

    def zeta_scale(self, state: TrainState) -> Optional[torch.Tensor]:
        """The zeta_warmup ramp min(step / warmup, 1) as a 0-d device
        tensor read from ``state.step``, or None without a ramp. At a
        warm-up step the steric weight ramps 0 -> zeta over the first
        ``zeta_warmup`` optimizer steps."""
        warm = int(self.cfg.train.zeta_warmup or 0)
        if warm <= 0:
            return None
        return torch.clamp(state.step.to(torch.float32) / warm, max=1.0)

    def loss_and_grads(self, state: TrainState, batch: CGBatch,
                       generator: Optional[torch.Generator] = None, denominators=None):
        """(loss, metrics, gradients in ``state.params`` order) of one
        training batch, the steric weight on its warm-up ramp; metrics are
        detached 0-d device tensors."""
        params = list(state.params.values())
        loss, metrics = self._loss_fn(batch, generator, self.zeta_scale(state), denominators)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        return loss.detach(), {k: v.detach() for k, v in metrics.items()}, grads

    def apply_gradients(self, state: TrainState, loss: torch.Tensor,
                        grads: Sequence[torch.Tensor]) -> Tuple[TrainState, torch.Tensor]:
        """The guarded update: (new state, ok). The batch is accepted (ok)
        if its loss is finite and below gamma * loss_skip_factor and its
        gradient norm is finite; a rejected batch leaves the parameters,
        the moments and their count as they were."""
        with torch.no_grad():
            return self._apply_flat(state, loss, flatten(grads))

    def _apply_flat(self, state: TrainState, loss: torch.Tensor,
                    g: torch.Tensor) -> Tuple[TrainState, torch.Tensor]:
        tc = self.cfg.train
        lr_eff = state.lr
        if tc.lr_warmup > 0:
            # (step+1)/N so the ramp starts at 1/N, not a wasted 0-step
            lr_eff = lr_eff * torch.clamp(
                (state.step.to(torch.float32) + 1.0) / tc.lr_warmup, max=1.0)
        thresh = tc.gamma * tc.loss_skip_factor if tc.gamma > 0 else math.inf
        opt_state, ok = guarded_update_flat(self.tx, list(state.params.values()), g, loss,
                                            state.opt_state, lr_eff, thresh, self._zero,
                                            self._tensor)
        return dataclasses.replace(state, opt_state=opt_state, step=state.step + 1), ok

    def train_step(self, state: TrainState, batch: CGBatch,
                   generator: Optional[torch.Generator] = None
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        """One optimizer step on ``batch`` (already on the device; under
        data parallelism the global batch, the same on every rank). Returns
        the new state and the step's metrics as 0-d device tensors."""
        if self.mesh.group is None:
            loss, metrics, grads = self.loss_and_grads(state, batch, generator)
            state, ok = self.apply_gradients(state, loss, grads)
        else:
            local, gen, den = self._shard(batch, generator)
            loss, metrics, grads = self.loss_and_grads(state, local, gen, den)
            if self._tensor is not None:
                grads = [self._local_gradient(grads)]
            keys = list(metrics)
            buf = self._all_reduce([*grads, loss, *(metrics[k] for k in keys)])
            p = buf.numel() - 1 - len(keys)
            metrics = dict(zip(keys, buf[p + 1:]))
            state, ok = self._apply_flat(state, buf[p], buf[:p])
        scale = ok.to(torch.float32)
        metrics.update(skipped=1.0 - scale, grad_ok=scale)
        return state, metrics

    def eval_step(self, batch: CGBatch, generator: Optional[torch.Generator] = None
                  ) -> Dict[str, torch.Tensor]:
        with torch.no_grad():
            if self.mesh.group is None:
                _, metrics = self._loss_fn(batch, generator)
                return metrics
            local, gen, den = self._shard(batch, generator)
            _, metrics = self._loss_fn(local, gen, denominators=den)
            keys = list(metrics)
            return dict(zip(keys, self._all_reduce([metrics[k] for k in keys])))

    @property
    def captures(self) -> bool:
        """Whether epoch programs replay a captured CUDA graph: on a card,
        unless the mesh's collectives are gloo's, which stage CUDA tensors
        through the host where no graph can hold them; then the same
        static step runs in a Python loop."""
        return self.device.type == "cuda" and self.mesh.backend in (None, "nccl")

    def _h_project_eval(self, xyz: torch.Tensor, batch: CGBatch) -> torch.Tensor:
        """The eval-only H bond-length projection (``h_project_eval``):
        training sees the raw decoder, reconstruct and generate outputs get
        the constraint, with bond lengths from the batch's atoms."""
        if self.cfg.model.h_project_eval:
            return project_batch_h_bonds(xyz, batch)
        return xyz

    def reconstruct(self, batch: CGBatch, generator: Optional[torch.Generator] = None
                    ) -> torch.Tensor:
        """(B*N, 3) reconstruction of ``batch`` through the posterior, on
        the device."""
        batch = batch.to(self.device)
        with torch.inference_mode():
            return self._h_project_eval(self.model(batch, generator=generator).xyz_recon,
                                        batch)

    def generate(self, batch: CGBatch, generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """(B*N, 3) coordinates drawn from the prior given the CG geometry
        of ``batch``, on the device."""
        batch = batch.to(self.device)
        with torch.inference_mode():
            return self._h_project_eval(self.model.generate(batch, generator=generator),
                                        batch)

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

    # ------------------------------------------- the epoch as one program
    def _run_program(self, state: Optional[TrainState], dds: DeviceDataset,
                     batches: np.ndarray, generator: Optional[torch.Generator],
                     train: bool, capture: bool) -> Tuple[Optional[TrainState], Dict[str, float]]:
        key = (id(dds), train)
        prog = self._programs.get(key)
        if prog is None:
            max_steps = max(batches.shape[0], dds.xyz.shape[0] // self.cfg.data.batch_size)
            prog = self._programs[key] = _EpochProgram(self, dds, train, max_steps)
        out = prog.run(state, batches, generator, capture)
        return (prog.state if train else state), out

    def run_epoch_scan(
        self, state: TrainState, dds: DeviceDataset,
        generator: Optional[torch.Generator] = None,
        shuffle_rng: Optional[np.random.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Train one epoch over a DeviceDataset as one program: on a CUDA
        device, replays of the captured step (captured at the first call
        for this dataset); on the CPU the same static step in a loop. The
        returned state's optimizer tensors are the program's static ones,
        updated in place by later epochs."""
        batches = epoch_index_batches(dds.n_frames, self.cfg.data.batch_size, shuffle_rng)
        return self._run_program(state, dds, batches, generator, True, self.captures)

    def run_epoch_scan_eval(self, params, dds: DeviceDataset,
                            generator: Optional[torch.Generator] = None) -> Dict[str, float]:
        """Evaluate one epoch over a DeviceDataset as one program (the
        val set cycled to whole batches). ``params`` is kept for the JAX
        package's signature: the model evaluates its own parameters, which
        ``state.params`` holds."""
        batches = epoch_index_batches(dds.n_frames, self.cfg.data.batch_size, None)
        return self._run_program(None, dds, batches, generator, False, self.captures)[1]

    def run_epoch_streamed(
        self, state: TrainState, dataset: CGDatasetArrays,
        generator: Optional[torch.Generator], chunk_frames: int,
        shuffle_rng: Optional[np.random.Generator] = None,
    ) -> Tuple[TrainState, Dict[str, float]]:
        """Epoch over a dataset too large for device memory: the frames go
        to the device in chunks, each trained as one program, chunk c
        drawing from a generator seeded from (the generator's seed, c) as
        the JAX package folds c into its key. Two static chunk buffers
        alternate; on a CUDA device the next chunk's copy runs from pinned
        memory on a side stream while this chunk's steps replay, and the
        replays wait for its event. chunk_frames should be a multiple of
        the batch size; a tail chunk cycles as usual."""
        bs = self.cfg.data.batch_size
        order = np.arange(len(dataset))
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        chunks = [order[lo:lo + chunk_frames] for lo in range(0, len(order), chunk_frames)
                  if len(order) - lo >= bs or lo == 0]
        seed = generator.initial_seed() if generator is not None else torch.initial_seed()
        cap = max(len(c) for c in chunks)
        if self._stream_buffers is None or self._stream_buffers[0] is not dataset \
                or self._stream_buffers[1] < cap:
            self._stream_buffers = (dataset, cap, [
                DeviceDataset.from_dataset(dataset.subset(order[:cap]), self.device)
                for _ in range(2)])
        buffers = self._stream_buffers[2]
        cuda = self.device.type == "cuda"
        copy_stream = torch.cuda.Stream(self.device) if cuda else None
        ready: List[Optional[torch.cuda.Event]] = [None, None]
        pinned = []                  # host copies kept alive until their copy ends

        def fill(c: int) -> None:
            buf, idx = buffers[c % 2], chunks[c]
            host = [torch.from_numpy(np.ascontiguousarray(getattr(dataset, k)[idx])).to(
                getattr(buf, k).dtype) for k in STREAMED_FIELDS]
            dests = [getattr(buf, k)[:len(idx)] for k in STREAMED_FIELDS]
            if cuda:
                host = [h.pin_memory() for h in host]
                pinned.append(host)
                # the replays that read this buffer (chunk c - 2) come first
                copy_stream.wait_stream(torch.cuda.current_stream(self.device))
                with torch.cuda.stream(copy_stream):
                    for dest, h in zip(dests, host):
                        dest.copy_(h, non_blocking=True)
                    ready[c % 2] = torch.cuda.Event()
                    ready[c % 2].record(copy_stream)
            else:
                for dest, h in zip(dests, host):
                    dest.copy_(h)
            buf.n_frames = len(idx)

        agg: Dict[str, list] = {}
        n_steps = 0
        fill(0)
        for c in range(len(chunks)):
            if c + 1 < len(chunks):
                fill(c + 1)          # enqueued before this chunk's steps
            if cuda:
                torch.cuda.current_stream(self.device).wait_event(ready[c % 2])
            state, m = self.run_epoch_scan(state, buffers[c % 2],
                                           derived_generator(self.device, seed, c))
            steps = m.pop("n_steps")
            n_steps += steps
            for k, v in m.items():
                agg.setdefault(k, []).append((v, steps))
        if cuda:
            torch.cuda.current_stream(self.device).synchronize()
        out = {k: float(sum(v * w for v, w in vs) / sum(w for _, w in vs))
               for k, vs in agg.items()}
        out["n_steps"] = n_steps
        return state, out

    def shards(self, state: TrainState) -> Dict[str, torch.Tensor]:
        """Under tensor parallelism, this model rank's shard of every
        sharded parameter (a copy), by name; {} otherwise."""
        if self._tensor is None:
            return {}
        params = list(state.params.values())
        parts = self._tensor.split(self._tensor.local([p.detach() for p in params]))
        return {n: part.clone() for n, part, spec in zip(
            self._tensor.names, parts, self._tensor.specs) if spec is not None}

    def _full_moments(self, state: TrainState) -> TrainState:
        """``state`` with every rank's ZeRO-1 or tensor-parallel moments
        gathered (a collective), as a checkpoint stores them; ``state``
        itself otherwise."""
        opt = state.opt_state
        if self._tensor is not None:
            return dataclasses.replace(state, opt_state=AdamState(
                count=opt.count, mu=self._tensor.full(opt.mu), nu=self._tensor.full(opt.nu)))
        if self._zero is None:
            return state
        mesh, _, padded = self._zero
        n = sum(p.numel() for p in state.params.values())

        def gather(t: torch.Tensor) -> torch.Tensor:
            out = torch.empty(padded, dtype=torch.float32, device=t.device)
            return all_gather_(out, t.to(torch.float32), mesh)[:n].to(t.dtype)

        return dataclasses.replace(state, opt_state=AdamState(
            count=opt.count, mu=gather(opt.mu), nu=gather(opt.nu)))

    def _own_moments(self, state: TrainState) -> TrainState:
        """The inverse of ``_full_moments``: this rank's slice of full
        moments."""
        opt = state.opt_state
        if self._tensor is not None:
            return dataclasses.replace(state, opt_state=AdamState(
                count=opt.count, mu=self._tensor.own(opt.mu), nu=self._tensor.own(opt.nu)))
        if self._zero is None:
            return state
        _, part, padded = self._zero

        def own(t: torch.Tensor) -> torch.Tensor:
            return torch.nn.functional.pad(t, (0, padded - t.numel()))[part].clone()

        return dataclasses.replace(state, opt_state=AdamState(
            count=opt.count, mu=own(opt.mu), nu=own(opt.nu)))

    def release_graphs(self) -> None:
        """Free the captured graphs, their memory pools and the chunk
        buffers; the next epoch program captures anew."""
        for prog in self._programs.values():
            prog.release()
        self._programs.clear()
        self._stream_buffers = None

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
        both splits on the device (DeviceDataset) and runs each epoch as one
        program (``run_epoch_scan``, ``run_epoch_scan_eval``: on a CUDA
        device replays of a captured step, freed when fit returns); False,
        or a dataset with per-frame aux edges, streams host batches
        through the eager step.

        ckpt: an optional ``train.checkpoint.CheckpointManager``. The full
        train state is saved when the run stops, on the final epoch and
        every ``cfg.train.checkpoint_every`` epochs; resume=True restarts
        from its latest checkpoint (parameters copied into the model,
        moments, step, lr, controller and early-stop counters, history) at
        the next epoch. Epoch e draws its noise from generators seeded from
        (seed, e), as the JAX package folds e into its key; the shuffle
        order restarts from ``default_rng(seed)`` in every call, as the JAX
        package's does. Under data parallelism every rank runs ``fit`` on
        the same splits; rank 0 alone saves (ZeRO-1 moments gathered
        first), and every rank restores."""
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
        # hold the plateau controller and the stopper while a warm-up ramp
        # (zeta_warmup with the steric term on, or lr_warmup) runs: the
        # tracked loss moves because the objective moves
        steps_per_epoch = max(len(trainset) // max(self.cfg.data.batch_size, 1), 1)
        warm_steps = max(tc.zeta_warmup if (tc.zeta and self.steric_tables is not None)
                         else 0, tc.lr_warmup)
        warm_epochs = -(-warm_steps // steps_per_epoch)

        dds_train = dds_val = None
        if on_device and trainset.aux_bonds is None:
            dds_train = DeviceDataset.from_dataset(trainset, self.device)
            dds_val = DeviceDataset.from_dataset(valset, self.device)

        if resume and ckpt is not None and ckpt.latest_step() is not None:
            state, meta, _ = ckpt.restore(self._full_moments(state))
            state = self._own_moments(state)
            start_epoch = int(meta.get("epoch", -1)) + 1
            controller.load_state(meta.get("controller", {}))
            stopper.load_state(meta.get("stopper", {}))
            history = meta.get("history", [])
            state = self.set_lr(state, controller.lr)

        try:
            for epoch in range(start_epoch, n_epochs):
                t0 = time.time()
                train_gen = derived_generator(self.device, seed, epoch)
                val_gen = derived_generator(self.device, seed, epoch, 999)
                if dds_train is not None:
                    state, train_m = self.run_epoch_scan(
                        state, dds_train, train_gen, shuffle_rng=shuffle_rng)
                    val_m = self.run_epoch_scan_eval(state.params, dds_val, val_gen)
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
                    full = self._full_moments(state)
                    if self.mesh.rank == 0:      # one writer; every rank reads on resume
                        ckpt.save(epoch, full, metadata={
                            "epoch": epoch,
                            "controller": controller.save_state(),
                            "stopper": stopper.save_state(),
                            "history": history,
                        })
                if stop:
                    break
        finally:
            self.release_graphs()
        return state, history
