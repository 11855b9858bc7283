"""Ablation profiler for the flagship train step on the PyTorch port
(``examples/profile_flagship.py``'s sections, dipeptide bench config).

Times the full captured train step (``Trainer.run_epoch_scan``'s program),
its depth variants, value_and_grad alone, forward plus loss alone, and each
module family fwd+bwd at its in-model shapes times its count in the model.
Each row is one step captured in a CUDA graph and replayed ``--steps``
times (the train step: the trainer's own captured program over an epoch of
``--steps`` steps of one batch), so the host's launch cost stays out; it
gives the host-clock ms per step over the replays, ending in a sync, and
the device ms per step (busy time, the union of kernel intervals) of a
``torch.profiler`` window over further replays. With ``--device cpu`` each
row runs its step in a Python loop, timed by the host clock, and has no
device time. Prints one JSON line per measurement, with the original's
labels; the modules section keeps the original's counts (encoder and prior
messages x4, atom updates x4, CG updates x5, contractions x4, pseudo
messages x5) for both configs.

The port has one formulation of each module on the card (the factored
message and the pseudo message always run their CUDA kernels), so the
original's ``--impl`` and ``--pseudo-impl`` are gone. The module rows feed
the port's modules what they take: node coordinates and masks (the kernels
build the pair geometry and the cutoff adjacency), so the prior message
builds its graph at its own cutoff, 9.5, where the original hands it an
adjacency at the atom cutoff, 8.5.

Usage:  python examples/profile_flagship_torch.py [--steps 50] [--batch 32]
            [--config dipeptide|chignolin] [--dtype float32|bfloat16]
            [--adam_dtype float32|bfloat16] [--only step,layers,parts,modules]
            [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time
from types import SimpleNamespace

import numpy as np
import torch

CONFIGS = {
    # the reference README.md:64 hyperparameters (dec_type=cross)
    "chignolin": dict(n_cgs=6, n_basis=600, n_rbf=10, atom_cutoff=12.0, cg_cutoff=25.0,
                      enc_nconv=2, dec_nconv=9, activation="swish", dec_type="cross",
                      breaksym=False),
    "dipeptide": dict(n_cgs=3, n_basis=600, n_rbf=8, atom_cutoff=8.5, cg_cutoff=9.5,
                      enc_nconv=4, dec_nconv=5, activation="swish", dec_type="pseudo",
                      breaksym=True),
}
# (enc_nconv, dec_nconv) of the layers section, on the dipeptide's model
LAYERS = ((2, 5), (4, 1), (0, 5), (4, 5))
# (label, count in the model) of the modules section
MODULES = (("enc_factored_message", 4), ("prior_factored_message", 4), ("update_atoms", 4),
           ("update_cg", 5), ("enc_contractive", 4), ("dec_pseudo_message", 5))
SECTIONS = ("step", "layers", "parts", "modules")
PROFILE_STEPS = 5
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def experiment(config: str, batch_size: int, dtype: str, adam_dtype: str,
               n_basis: int = 600, **model_kw):
    """The original's ExperimentConfig (profile_flagship.py:86-106)."""
    from coarsegrainingvae_tpu_torch.config import (DataConfig, ExperimentConfig,
                                                    ModelConfig, TrainConfig)

    mc = {**CONFIGS[config], "n_basis": n_basis, **model_kw}
    return ExperimentConfig(
        model=ModelConfig(**mc, compute_dtype=dtype),
        data=DataConfig(batch_size=batch_size),
        train=TrainConfig(lr=8e-5, beta=0.05, gamma=25.0, grad_clip=0.01,
                          adam_moment_dtype=adam_dtype),
    )


def setup(config: str = "dipeptide", batch: int = 32, dtype: str = "float32",
          adam_dtype: str = "float32", device="cuda", n_basis: int = 600):
    """The original's data, model, trainer and batch (profile_flagship.py:
    80-127): (cfg, dataset, batch on the device, trainer, state)."""
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    batch_size = 2 if config == "chignolin" and batch == 32 else batch
    cfg = experiment(config, batch_size, dtype, adam_dtype, n_basis)
    z, frames, bonds = synthetic_peptide(config, n_frames=max(64, 2 * batch_size), seed=0,
                                         device=device)
    mapping = newman_mapping(bonds, z.shape[0], cfg.model.n_cgs, seed=0)
    ds = build_dataset(mapping, frames, atom_cutoff=cfg.model.atom_cutoff,
                       cg_cutoff=cfg.model.cg_cutoff, atomic_nums=z, bonds=bonds,
                       order=2, rotate=True)
    tr, state = trainer(cfg, ds, device)
    return cfg, ds, ds.batch(np.arange(batch_size)).to(device), tr, state


def trainer(cfg, ds, device):
    """A Trainer on a DenseCGVAE drawn from seed 0, and its state."""
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device=device)
    return tr, tr.init_state(ds.batch(np.arange(cfg.data.batch_size)))


def forward_loss(tr, batch, generator=None) -> torch.Tensor:
    """The original's ``loss_fn``: the model's forward and ``vae_loss`` at
    beta and gamma, nothing else (profile_flagship.py:170-175)."""
    from coarsegrainingvae_tpu_torch.models.cgvae import flatten_batch
    from coarsegrainingvae_tpu_torch.train.losses import vae_loss

    out = tr.model(batch, generator=generator)
    return vae_loss(out, flatten_batch(batch), tr.cfg.train.beta, tr.cfg.train.gamma)[0]


def _row(label: str, host_ms: float, device: dict, items: float = 0.0) -> dict:
    row = {"label": label, "ms_per_step": host_ms}
    if items:
        row["items_per_s"] = items / host_ms * 1e3
    row.update(device)
    print(json.dumps(row), flush=True)
    return row


def _window(run, steps: int) -> dict:
    """Device ms per step, busy share and device events per step of a
    profiler window over ``run()``, which takes ``steps`` steps."""
    from torch.profiler import ProfilerActivity, profile

    from coarsegrainingvae_tpu_torch.utils.profiling import device_profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    p = device_profile(prof, wall_ms, steps)
    return {"device_ms_per_step": p["busy_ms"] / steps, "busy_share": p["busy_share"],
            "device_events_per_step": p["device_events_per_step"]}


NO_DEVICE = {"device_ms_per_step": None, "busy_share": None, "device_events_per_step": None}


def replay_times(fn, steps: int, device: torch.device) -> tuple:
    """(host ms per step, device numbers) of ``fn``, one step: on the card
    captured once (``utils.profiling.Replays``, the kernels' launches
    counted per replay) and replayed ``steps`` times, then PROFILE_STEPS
    times under the profiler; on the CPU called in a loop."""
    if device.type != "cuda":
        fn()
        t = time.perf_counter()
        for _ in range(steps):
            fn()
        return (time.perf_counter() - t) / steps * 1e3, dict(NO_DEVICE)
    from coarsegrainingvae_tpu_torch.utils.profiling import Replays

    run = Replays(fn, 1)
    run.replay()
    torch.cuda.synchronize()
    t = time.perf_counter()
    run.replay(steps)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / steps * 1e3
    dev = _window(lambda: run.replay(PROFILE_STEPS), PROFILE_STEPS)
    run.reset()
    return host_ms, dev


def time_train_step(tr, state, ds, batch_size: int, steps: int, label: str) -> tuple:
    """The captured train step: epochs of ``steps`` steps on the first
    batch repeated (no shuffle), the first capturing, the second timed (its
    mean loss in the row), a third under the profiler. Returns (row,
    state)."""
    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset

    dds = DeviceDataset.from_dataset(ds.subset(np.resize(np.arange(batch_size),
                                                         steps * batch_size)), tr.device)
    gen = torch.Generator(device=tr.device).manual_seed(0)
    state, _ = tr.run_epoch_scan(state, dds, gen)
    cuda = tr.device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    t = time.perf_counter()
    state, m = tr.run_epoch_scan(state, dds, gen)
    if cuda:
        torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) / steps * 1e3
    dev = {"loss": m["loss"], **NO_DEVICE}
    if cuda:
        holder = {}

        def run():
            holder["state"], _ = tr.run_epoch_scan(state, dds, gen)

        dev.update(_window(run, steps))
        state = holder["state"]
    tr.release_graphs()
    return _row(label, host_ms, dev, batch_size), state


def module_inputs(cfg, batch, generator: torch.Generator) -> SimpleNamespace:
    """The modules' inputs at their in-model shapes (profile_flagship.py:
    219-229): random node features of the atoms (B, N) and the beads (B, M),
    the batch's coordinates, masks and one-hot assignment."""
    b, n = batch.z.shape
    m, f = cfg.model.n_cgs, cfg.model.n_basis
    dev = batch.xyz.device

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=dev)

    return SimpleNamespace(
        h=randn(b, n, f), v=randn(b, n, 3, f), H=randn(b, m, f), V=randn(b, m, 3, f),
        r_iI=randn(b, n, 3), xyz=batch.xyz, atom_mask=batch.atom_mask,
        cg_xyz=batch.cg_xyz, cg_mask=batch.cg_mask,
        onehot=torch.nn.functional.one_hot(batch.mapping, m).to(torch.float32))


def modules(cfg, x, dtype: torch.dtype) -> list:
    """(label, count, module, inputs) of each module family, the module's
    first input the one differentiated beside its parameters."""
    from coarsegrainingvae_tpu_torch.models.dense import (DenseFactoredEquiMessage,
                                                          DenseUpdateBlock)
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import (DenseContractive,
                                                                DenseEquiMessagePseudo)

    f = cfg.model.n_basis
    g = torch.Generator().manual_seed(1)
    built = {
        "enc_factored_message": (DenseFactoredEquiMessage(f, "swish", 8, 9.5, dtype=dtype,
                                                          generator=g),
                                 (x.h, x.v, x.xyz, x.atom_mask)),
        "prior_factored_message": (DenseFactoredEquiMessage(f, "swish", 8, 9.5, dtype=dtype,
                                                            generator=g),
                                   (x.H, x.V, x.cg_xyz, x.cg_mask)),
        "update_atoms": (DenseUpdateBlock(f, "swish", dtype, g), (x.h, x.v)),
        "update_cg": (DenseUpdateBlock(f, "swish", dtype, g), (x.H, x.V)),
        "enc_contractive": (DenseContractive(f, "swish", 8, cfg.model.contract_cutoff, dtype, g),
                            (x.h, x.v, x.r_iI, x.onehot)),
        "dec_pseudo_message": (DenseEquiMessagePseudo(f, "swish", 8, 8.5, dtype, g),
                               (x.H, torch.ones_like(x.H), x.V, torch.zeros_like(x.V),
                                x.cg_xyz, x.cg_mask)),
    }
    return [(label, count) + built[label] for label, count in MODULES]


def module_step(mod, inputs) -> None:
    """fwd+bwd of one module: sum of its outputs squared, differentiated in
    its parameters and its first input."""
    x0 = inputs[0].detach().requires_grad_(True)
    out = mod(x0, *inputs[1:])
    loss = sum(torch.sum(o.float() ** 2) for o in out)
    torch.autograd.grad(loss, [*mod.parameters(), x0])


def main(argv=None, n_basis: int = 600) -> list:
    """The rows printed, as dicts. ``n_basis`` is the width (600 in the
    original; tests run narrower)."""
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--config", default="dipeptide", choices=["dipeptide", "chignolin"])
    p.add_argument("--dtype", default="float32")
    p.add_argument("--only", default="", help="comma list: step,layers,parts,modules "
                   "(default step,parts,modules, as in the original)")
    p.add_argument("--adam_dtype", default="float32",
                   help="Adam moment storage dtype (float32|bfloat16)")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    which = set(a.only.split(",")) if a.only else {"step", "parts", "modules"}
    unknown = which - set(SECTIONS)
    if unknown:
        raise ValueError(f"unknown sections {sorted(unknown)}; have {SECTIONS}")
    device = torch.device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg, ds, batch, tr, state = setup(a.config, a.batch, a.dtype, a.adam_dtype, device, n_basis)
    bs = cfg.data.batch_size
    rows = []
    head = {"label": "shape", "B": bs, "N": int(batch.z.shape[1]), "M": cfg.model.n_cgs,
            "F": cfg.model.n_basis, "backend": device.type}
    if device.type == "cuda":
        head["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(head), flush=True)
    rows.append(head)

    if "step" in which:
        row, state = time_train_step(tr, state, ds, bs, a.steps, "train_step_full")
        rows.append(row)

    if "layers" in which:
        # conv depths varied: in-step per-layer costs, with the fusion and
        # overlap that standalone module rows lack
        for enc, dec in LAYERS:
            cfg2 = experiment("dipeptide", bs, a.dtype, a.adam_dtype, n_basis,
                              enc_nconv=enc, dec_nconv=dec)
            tr2, st2 = trainer(cfg2, ds, device)
            rows.append(time_train_step(tr2, st2, ds, bs, a.steps,
                                        f"train_step_enc{enc}_dec{dec}")[0])
            del tr2, st2

    if "parts" in which:
        params = list(state.params.values())

        def grad_only():            # value_and_grad: no clip, no Adam, no update
            torch.autograd.grad(forward_loss(tr, batch), params)

        def fwd():
            with torch.no_grad():
                forward_loss(tr, batch)

        for label, fn in (("value_and_grad", grad_only), ("forward_loss", fwd)):
            rows.append(_row(label, *replay_times(fn, a.steps, device), bs))

    if "modules" in which:
        # module level: exact in-model shapes, fwd+bwd each
        x = module_inputs(cfg, batch, torch.Generator(device=device).manual_seed(1))
        for label, count, mod, inputs in modules(cfg, x, DTYPES[a.dtype]):
            mod = mod.to(device)
            host_ms, dev = replay_times(lambda: module_step(mod, inputs), a.steps, device)
            rows.append(_row(f"{label} (x{count})", host_ms, dev))
            total = {"label": label + "_total", "ms": host_ms * count,
                     "device_ms": None if dev["device_ms_per_step"] is None
                     else dev["device_ms_per_step"] * count}
            print(json.dumps(total), flush=True)
            rows.append(total)
    return rows


if __name__ == "__main__":
    main()
