"""What the ranks of the port's multi-rank tests run (tests/test_torch_parallel.py,
tests/test_torch_halo.py, tests/test_torch_chip_smoke.py).

The tests spawn their ranks with ``parallel.launch.spawn_ranks``, which
imports the function it runs by name in every new process; this module
imports torch and the port only, so a rank starts without JAX. The same
functions run in the test process on one rank with no process group (the
reference), so each case is written once.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
from coarsegrainingvae_tpu_torch.parallel import halo
from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh, make_mesh
from coarsegrainingvae_tpu_torch.train.trainer import Trainer


def _mesh(parallel: bool, device: str) -> Mesh:
    return make_mesh(device=device) if parallel else Mesh(0, 1, None, None,
                                                         torch.device(device))


def _trainer(cfg, mesh: Mesh, state_dict=None, seed: int = 0):
    model = build_flagship_model(cfg.model, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return Trainer(model, cfg, device=mesh.device, mesh=mesh)


def _numpy_params(state) -> Dict[str, np.ndarray]:
    return {k: p.detach().cpu().numpy().copy() for k, p in state.params.items()}


def train_steps(cfg, batches: List, parallel: bool, state_dict=None, seed: int = 0,
                gen_seed: Optional[int] = None, device: str = "cpu") -> dict:
    """``train_step`` over the global ``batches`` (every rank gets all of
    them) on ``device``; the parameters after, each step's metrics, the
    moments held."""
    tr = _trainer(cfg, _mesh(parallel, device), state_dict, seed)
    state = tr.init_state(batches[0])
    before = _numpy_params(state)
    gen = None if gen_seed is None else torch.Generator(device=device).manual_seed(gen_seed)
    metrics = []
    for b in batches:
        state, m = tr.train_step(state, b.to(device), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    params = _numpy_params(state)
    return {"params": params, "metrics": metrics, "moments": state.opt_state.mu.numel(),
            "unchanged": all(np.array_equal(params[k], before[k]) for k in params)}


def epoch(cfg, train_ds, val_ds, parallel: bool, seed: int = 0, gen_seed: int = 3,
          shuffle_seed: int = 4) -> dict:
    """One epoch of the static step (``run_epoch_scan``; the loop on the
    CPU) and one of the eval step over DeviceDatasets."""
    tr = _trainer(cfg, _mesh(parallel, "cpu"), seed=seed)
    state = tr.init_state(train_ds.batch(np.arange(cfg.data.batch_size)))
    gen = torch.Generator().manual_seed(gen_seed)
    state, train_m = tr.run_epoch_scan(state, DeviceDataset.from_dataset(train_ds, "cpu"), gen,
                                       shuffle_rng=np.random.default_rng(shuffle_seed))
    val_m = tr.run_epoch_scan_eval(state.params, DeviceDataset.from_dataset(val_ds, "cpu"),
                                   torch.Generator().manual_seed(gen_seed + 1))
    return {"params": _numpy_params(state), "train": train_m, "val": val_m}


def fit_resume(cfg, train_ds, val_ds, ckpt_dir: str, parallel: bool) -> dict:
    """``fit`` one epoch with a checkpoint manager (rank 0 saves), then a
    new trainer from other weights resumed from it to two epochs: the
    parameters and moments after, and the moments the checkpoint stored."""
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager

    mesh = _mesh(parallel, "cpu")
    first = train_ds.batch(np.arange(cfg.data.batch_size))
    tr = _trainer(cfg, mesh, seed=0)
    tr.fit(tr.init_state(first), train_ds, val_ds, nepochs=1, ckpt=CheckpointManager(ckpt_dir))
    if mesh.group is not None:
        torch.distributed.barrier(group=mesh.group)
    stored, _, _ = CheckpointManager(ckpt_dir).read()
    tr = _trainer(cfg, mesh, seed=1)
    state, _ = tr.fit(tr.init_state(first), train_ds, val_ds, nepochs=2,
                      ckpt=CheckpointManager(ckpt_dir), resume=True)
    return {"params": _numpy_params(state), "mu": state.opt_state.mu.float().numpy(),
            "stored_mu": stored["opt_state"]["mu"].float().numpy(),
            "stored_nu": stored["opt_state"]["nu"].float().numpy()}


def halo_cases(cases: dict, parallel: bool = True, device: str = "cpu") -> dict:
    """Each case (xyz, edges, s, v, kw, state_dict, stack): on this rank's
    block of the plan's sharded order, ``halo_message`` (one
    EquiMessageBlock) or ``halo_stack_apply`` (an EquiStack) forward, and
    the gradients of sum(s'^2) + sum(v'^2) with respect to the parameters
    (summed over the ranks) and to this rank's block of s, on ``device``."""
    mesh = _mesh(parallel, device)
    out = {}
    for name, c in cases.items():
        plan = halo.plan_halo(c["xyz"], c["edges"], mesh.size, c["halo"])
        if c["stack"]:
            module = halo.EquiStack(**c["kw"])
        else:
            kw = c["kw"]
            module = halo.EquiMessageBlock(kw["feat_dim"], kw["activation"], kw["n_rbf"],
                                           kw["cutoff"])
        module.load_state_dict({k: torch.as_tensor(v) for k, v in c["state_dict"].items()})
        module.to(device)

        def block(a):
            return torch.as_tensor(plan.block(plan.pad(a), mesh.rank)).to(device)

        s = block(c["s"]).requires_grad_(True)
        if c["stack"]:
            so, vo = halo.halo_stack_apply(module, s, block(c["v"]), block(c["xyz"]), plan, mesh)
        else:
            so, vo = halo.halo_message(module, s, block(c["v"]), block(c["xyz"]), plan, mesh)
        loss = (so ** 2).sum() + (vo ** 2).sum()
        names = [k for k, _ in module.named_parameters()]
        grads = torch.autograd.grad(loss, [p for _, p in module.named_parameters()] + [s])
        g_params = {}
        for k, g in zip(names, grads[:-1]):
            if mesh.group is not None:
                torch.distributed.all_reduce(g, group=mesh.group)
            g_params[k] = g.cpu().numpy()
        out[name] = {"s": so.detach().cpu().numpy(), "v": vo.detach().cpu().numpy(),
                     "grads": g_params, "g_s": grads[-1].cpu().numpy(), "rank": mesh.rank}
    return out


def run_all(cases: dict) -> dict:
    """Every (function, kwargs) of ``cases`` on this rank, in one process
    group."""
    return {name: fn(**kwargs, parallel=True) for name, (fn, kwargs) in cases.items()}


def replace_parallel(cfg, **kw):
    return dataclasses.replace(cfg, parallel=dataclasses.replace(cfg.parallel, **kw))


def fail_on(rank: int) -> None:
    """Raise on ``rank``; the other ranks wait for it at a barrier."""
    if torch.distributed.get_rank() == rank:
        raise ValueError(f"rank {rank} fails")
    torch.distributed.barrier()
