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
import shutil
from typing import Dict, List, Optional

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.device import DeviceDataset
from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
from coarsegrainingvae_tpu_torch.parallel import halo
from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh, make_mesh
from coarsegrainingvae_tpu_torch.train.trainer import Trainer


def _mesh(parallel: bool, device: str, model_devices: int = 1) -> Mesh:
    if parallel:
        return make_mesh(model_devices=model_devices, device=device)
    return Mesh(0, 1, None, None, torch.device(device))


def _trainer(cfg, mesh: Mesh, state_dict=None, seed: int = 0):
    model = build_flagship_model(cfg.model, generator=torch.Generator().manual_seed(seed))
    if state_dict is not None:
        model.load_state_dict({k: torch.as_tensor(v) for k, v in state_dict.items()})
    return Trainer(model, cfg, device=mesh.device, mesh=mesh)


def _numpy_params(state) -> Dict[str, np.ndarray]:
    return {k: p.detach().float().cpu().numpy().copy() for k, p in state.params.items()}


def train_steps(cfg, batches: List, parallel: bool, state_dict=None, seed: int = 0,
                gen_seed: Optional[int] = None, device: str = "cpu") -> dict:
    """``train_step`` over the global ``batches`` (every rank gets all of
    them) on ``device``; the parameters after, each step's metrics, the
    moments held."""
    tr = _trainer(cfg, _mesh(parallel, device, cfg.parallel.model_devices), state_dict, seed)
    state = tr.init_state(batches[0])
    before = _numpy_params(state)
    gen = None if gen_seed is None else torch.Generator(device=device).manual_seed(gen_seed)
    metrics = []
    for b in batches:
        state, m = tr.train_step(state, b.to(device), gen)
        metrics.append({k: float(v) for k, v in m.items()})
    params = _numpy_params(state)
    return {"params": params, "metrics": metrics, "moments": state.opt_state.mu.numel(),
            "unchanged": all(np.array_equal(params[k], before[k]) for k in params),
            "rank": tr.mesh.rank, "mesh": tr.mesh.shape,
            "shards": {k: t.cpu().numpy() for k, t in tr.shards(state).items()}}


def epoch(cfg, train_ds, val_ds, parallel: bool, seed: int = 0, gen_seed: int = 3,
          shuffle_seed: int = 4) -> dict:
    """One epoch of the static step (``run_epoch_scan``; the loop on the
    CPU) and one of the eval step over DeviceDatasets."""
    tr = _trainer(cfg, _mesh(parallel, "cpu", cfg.parallel.model_devices), seed=seed)
    state = tr.init_state(train_ds.batch(np.arange(cfg.data.batch_size)))
    gen = torch.Generator().manual_seed(gen_seed)
    state, train_m = tr.run_epoch_scan(state, DeviceDataset.from_dataset(train_ds, "cpu"), gen,
                                       shuffle_rng=np.random.default_rng(shuffle_seed))
    val_m = tr.run_epoch_scan_eval(state.params, DeviceDataset.from_dataset(val_ds, "cpu"),
                                   torch.Generator().manual_seed(gen_seed + 1))
    return {"params": _numpy_params(state), "train": train_m, "val": val_m}


def fit_resume(cfg, train_ds, val_ds, ckpt_dir: str, parallel: bool,
               continued: bool = False) -> dict:
    """``fit`` one epoch with a checkpoint manager (rank 0 saves), then a
    new trainer from other weights resumed from it to two epochs: the
    parameters and moments after, the parameters after the first epoch,
    and what the checkpoint stored; with ``continued`` also the parameters
    of the first trainer, its epoch-0 state still in place, resumed to two
    epochs from a copy of the checkpoint."""
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager

    mesh = _mesh(parallel, "cpu", cfg.parallel.model_devices)
    first = train_ds.batch(np.arange(cfg.data.batch_size))
    tr = _trainer(cfg, mesh, seed=0)
    state, _ = tr.fit(tr.init_state(first), train_ds, val_ds, nepochs=1,
                      ckpt=CheckpointManager(ckpt_dir))
    after_one = _numpy_params(state)
    if continued and mesh.rank == 0:
        shutil.copytree(ckpt_dir, ckpt_dir + "_copy")
    if mesh.group is not None:
        torch.distributed.barrier(group=mesh.group)
    stored, _, _ = CheckpointManager(ckpt_dir).read()
    first_trainer = tr
    tr = _trainer(cfg, mesh, seed=1)
    state, _ = tr.fit(tr.init_state(first), train_ds, val_ds, nepochs=2,
                      ckpt=CheckpointManager(ckpt_dir), resume=True)
    out = {"params": _numpy_params(state), "mu": state.opt_state.mu.float().numpy(),
           "stored_mu": stored["opt_state"]["mu"].float().numpy(),
           "stored_nu": stored["opt_state"]["nu"].float().numpy(),
           "stored_params": {k: t.float().numpy() for k, t in stored["params"].items()},
           "after_one": after_one}
    if continued:
        state, _ = first_trainer.fit(first_trainer.init_state(first), train_ds, val_ds,
                                     nepochs=2, ckpt=CheckpointManager(ckpt_dir + "_copy"),
                                     resume=True)
        out["continued"] = _numpy_params(state)
    return out


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


def synthetic_frames(device: str, n_frames: int = 64, seed: int = 0) -> np.ndarray:
    """The synthetic dipeptide's relaxed frames, made on ``device``."""
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    return synthetic_peptide("dipeptide", n_frames=n_frames, seed=seed, device=device)[1]


def hpo_failing_rank(log_dir: str, fail_rank: int = 1) -> list:
    """``cli.hpo.random_search`` (4 trials) and ``asha_search`` (4 trials,
    2 rungs) with a stub objective that raises on ``fail_rank`` alone for
    its second trial; every rank's rows."""
    import os

    from coarsegrainingvae_tpu_torch.cli import hpo

    calls = []

    def objective(cfg, epochs=1):
        calls.append(cfg)
        if torch.distributed.get_rank() == fail_rank and len(calls) in (2, 6):
            raise RuntimeError(f"rank {fail_rank} fails")
        return cfg["lr"] * 1e3 + cfg["n_basis"] / 600 + 1.0 / epochs

    _, _, random_rows = hpo.random_search(objective, hpo.CGVAE_SPACE, 4, seed=3,
                                          log_path=os.path.join(log_dir, "hpo_log.csv"))
    _, _, asha_rows = hpo.asha_search(objective, hpo.CGVAE_SPACE, 4, min_epochs=1, max_epochs=2,
                                      reduction=2, seed=3,
                                      log_path=os.path.join(log_dir, "hpo_asha_log.csv"))
    return [random_rows, asha_rows]


def reconstruct_generate(cfg, batch, parallel: bool, state_dict=None, seed: int = 0,
                         gen_seed: int = 9) -> dict:
    """``Trainer.reconstruct``, ``generate`` and ``eval_step`` on ``batch``
    (every rank the whole batch) from ``state_dict``'s weights, each drawing
    from a generator seeded ``gen_seed``."""
    tr = _trainer(cfg, _mesh(parallel, "cpu", cfg.parallel.model_devices), state_dict, seed)
    tr.init_state(batch)

    def gen():
        return torch.Generator().manual_seed(gen_seed)

    return {"recon": tr.reconstruct(batch, gen()).numpy(),
            "generate": tr.generate(batch, gen()).numpy(),
            "eval": {k: float(v) for k, v in tr.eval_step(batch, gen()).items()}}


def mark_events(prof) -> List[tuple]:
    """(mark, start ns) of every phase-mark kernel (``utils.tracing``) on
    the card in a ``torch.profiler`` window, in the order they ran."""
    from torch.autograd import DeviceType

    from coarsegrainingvae_tpu_torch.utils import tracing

    names = {tracing.kernel_name(m): m for m in tracing.MARKS}
    return sorted(((names[e.name()], e.start_ns()) for e in prof.profiler.kineto_results.events()
                   if e.device_type() == DeviceType.CUDA and e.name() in names),
                  key=lambda m: m[1])


def profiled_marks(cfg, train_ds) -> dict:
    """On this rank's card (cuda:rank), one captured epoch over ``train_ds``
    (the capture), then one under ``torch.profiler``: its steps and the
    marks the trace shows, in order."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", torch.distributed.get_rank())
    torch.cuda.set_device(device)
    tr = _trainer(cfg, make_mesh(device=device))
    state = tr.init_state(train_ds.batch(np.arange(cfg.data.batch_size)))
    dds = DeviceDataset.from_dataset(train_ds, device)
    gen = torch.Generator(device=device).manual_seed(3)
    state, _ = tr.run_epoch_scan(state, dds, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, m = tr.run_epoch_scan(state, dds, gen)
        torch.cuda.synchronize(device)
    tr.release_graphs()
    return {"steps": m["n_steps"], "marks": [name for name, _ in mark_events(prof)]}
