"""The reference's loss, optimiser and batches, and ``readings``: what the
comparison reads of three training steps.

Frozen from the port at commit add70c80: ``train/losses.py::vae_loss``
(recon + beta KL + gamma graph + zeta steric, the steric weight on the
``zeta_warmup`` ramp), ``train/trainer.py``'s flat global-norm clip and
Adam with moments stored in ``adam_moment_dtype``, the ``lr_warmup`` ramp
and the skip-batch guard, ``data/topology.py::high_order_edges`` and
``channel_index_from_mapping``. The batches are worked out again here from
the frames, the topology and the mapping alone. Imports nothing of the port.

A configuration's ``model`` names its family: the module
``cgbench/reference/<model>.py``, with ``Model``, ``inputs`` and ``KEYS``
(``family``). ``TRAIN_KEYS`` are the loss, optimiser and data keys read
here; a key absent from a configuration takes the default below, the
port's own.
"""
from __future__ import annotations

import importlib
import math
from dataclasses import dataclass
from types import ModuleType
from typing import Dict, List, Optional

import numpy as np
import torch

from cgbench.reference import steric
from cgbench.reference.layers import set_precision

EPS = 1e-6
TRAIN_KEYS = ("beta", "gamma", "zeta", "zeta_warmup", "steric_margin", "steric_data_margin",
              "grad_clip", "adam_moment_dtype", "loss_skip_factor", "lr_warmup", "edgeorder")
DEFAULTS = {"zeta": 0.0, "zeta_warmup": 0, "steric_margin": 0.3, "steric_data_margin": False,
            "lr_warmup": 0}


def family(name: str) -> ModuleType:
    """The reference family ``cgbench/reference/<name>.py``."""
    return importlib.import_module(f"cgbench.reference.{name}")


def keys(cfg: dict) -> set:
    """Every configuration key the reference of ``cfg`` reads."""
    return set(family(cfg["model"]).KEYS) | set(TRAIN_KEYS)


def setting(cfg: dict, key: str):
    return cfg.get(key, DEFAULTS.get(key))


def high_order_edges(bonds: np.ndarray, order: int, n_atoms: int) -> np.ndarray:
    """Upper-triangular pairs within bond-graph distance <= order, sorted."""
    nbrs: list = [[] for _ in range(n_atoms)]
    for a, b in np.asarray(bonds, dtype=np.int64):
        nbrs[a].append(int(b))
        nbrs[b].append(int(a))
    out = []
    for i in range(n_atoms):
        frontier, seen = {i}, {i}
        for _ in range(order):
            frontier = {k for j in frontier for k in nbrs[j] if k not in seen}
            seen |= frontier
        out.extend((i, j) for j in seen if j > i)
    return np.asarray(sorted(out), dtype=np.int64).reshape(-1, 2)


def channel_index(mapping: np.ndarray) -> np.ndarray:
    """Atoms of one bead get channels 0, 1, 2, ... in atom order."""
    out = np.zeros_like(mapping)
    for cg in np.unique(mapping):
        idx = np.flatnonzero(mapping == cg)
        out[idx] = np.arange(idx.shape[0])
    return out


@dataclass
class Batch:
    """A padded batch, (B, N) / (B, M) arrays, every mask one; for the
    sparse model also its flat graph."""
    z: torch.Tensor
    xyz: torch.Tensor
    atom_mask: torch.Tensor
    cg_z: torch.Tensor
    cg_xyz: torch.Tensor
    cg_mask: torch.Tensor
    mapping: torch.Tensor
    channel_idx: torch.Tensor
    bonds: torch.Tensor          # (Eb, 2) global atom ids over the batch


class Molecule:
    """The topology and mapping of a configuration, with the graph-loss
    pairs and channels worked out from them."""

    def __init__(self, cfg: dict, device):
        mol = cfg["molecule"]
        self.device = torch.device(device)
        self.z = np.asarray(mol["z"], np.int64)
        self.mapping = np.asarray(mol["mapping"], np.int64)
        self.n, self.m = self.z.shape[0], int(self.mapping.max()) + 1
        self.pairs = high_order_edges(np.asarray(mol["bonds"]), cfg["edgeorder"], self.n)
        self.channels = channel_index(self.mapping)

    def batch(self, frames: np.ndarray, rows: np.ndarray) -> Batch:
        dev, b, n, m = self.device, len(rows), self.n, self.m
        xyz = torch.as_tensor(np.asarray(frames[rows], np.float32), device=dev)
        onehot = torch.nn.functional.one_hot(torch.as_tensor(self.mapping, device=dev), m)
        cg_xyz = torch.einsum("bnd,nk->bkd", xyz, onehot.float()) / onehot.sum(0).float()[:, None]

        def tile(a):
            return torch.as_tensor(a, device=dev).expand((b,) + a.shape)

        pairs = torch.as_tensor(self.pairs, device=dev)
        offsets = torch.arange(b, device=dev)[:, None, None] * n
        return Batch(z=tile(self.z), xyz=xyz, atom_mask=torch.ones((b, n), dtype=torch.bool,
                                                                   device=dev),
                     cg_z=tile(np.arange(m)), cg_xyz=cg_xyz,
                     cg_mask=torch.ones((b, m), dtype=torch.bool, device=dev),
                     mapping=tile(self.mapping), channel_idx=tile(self.channels),
                     bonds=(pairs[None] + offsets).reshape(-1, 2))


def vae_loss(out, bonds: torch.Tensor, beta: float, gamma: float, zeta: float = 0.0,
             tables: Optional[tuple] = None) -> torch.Tensor:
    """recon + beta KL(posterior || prior) + gamma graph, each a plain mean,
    + zeta times the steric hinge over ``tables`` where zeta is not 0."""
    var2 = out.prior_sigma**2
    kl = 0.5 * (torch.sum(out.sigma**2 / var2, -1) + torch.sum((out.mu - out.prior_mu) ** 2 / var2, -1)
                + torch.sum(torch.log(var2), -1) - torch.sum(torch.log(out.sigma**2), -1)
                - out.mu.shape[-1])
    recon = torch.mean((out.xyz_recon - out.xyz) ** 2)
    a, b = bonds[:, 0], bonds[:, 1]
    gen_d = torch.sqrt(torch.sum((out.xyz_recon[a] - out.xyz_recon[b]) ** 2, -1) + EPS)
    dat_d = torch.sqrt(torch.sum((out.xyz[a] - out.xyz[b]) ** 2, -1) + EPS)
    total = recon + beta * torch.mean(kl) + gamma * torch.mean((gen_d - dat_d) ** 2)
    if zeta != 0.0:
        total = total + zeta * steric.loss(out.xyz_recon, *tables)
    return total


def build_model(cfg: dict, device, weights: Dict[str, torch.Tensor],
                precision: Optional[str] = None) -> torch.nn.Module:
    """The reference model of ``cfg["model"]`` on ``device`` holding
    ``weights`` (name -> tensor), at the configuration's precision or the
    lower ``precision`` of the control."""
    with torch.device("meta"):
        model = family(cfg["model"]).Model(cfg)
    model.to_empty(device=device)
    names = [n for n, _ in model.named_parameters()]
    if sorted(names) != sorted(weights):
        raise ValueError("the weights do not match the reference's parameters")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(weights[name])
    return set_precision(model, precision or cfg["compute_dtype"])


def leaf_norms(flat: torch.Tensor, sizes: List[int]) -> torch.Tensor:
    """Per-leaf L2 norms of a flat vector, in float64."""
    return torch.stack([torch.linalg.vector_norm(t.double()) for t in torch.split(flat, sizes)])


def readings(cfg: dict, frames: np.ndarray, steps: List[np.ndarray], lr: float,
             noise_seed: int, weights: Dict[str, torch.Tensor], device,
             precision: Optional[str] = None, fault: Optional[str] = None,
             count_flops: bool = False, shards: int = 1) -> dict:
    """Three (or ``len(steps)``) training steps of the reference from
    ``weights`` on the frames' ``steps`` rows, the noise drawn from a
    generator seeded ``noise_seed``: each step's loss, per-leaf norms of
    the first clipped gradient as Adam's first moment holds it, of the
    parameters' change over the steps, and of the exact first gradient.
    ``fault`` plants a fault of the step: "half_batch", the mean over the
    first half of the rows only; "no_exchange", what rank 0 of ``shards``
    data-parallel ranks computes without the all-reduce (its rows' sum over
    the global batch's count). ``count_flops``: the first step's
    forward and backward FLOPs as ``torch.utils.flop_counter`` counts them."""
    fam = family(cfg["model"])
    model = build_model(cfg, device, weights, precision)
    mol = Molecule(cfg, device)
    zeta, zeta_warmup, lr_warmup = (setting(cfg, k) for k in ("zeta", "zeta_warmup", "lr_warmup"))
    tables = None
    if zeta != 0.0:
        mol_cfg = cfg["molecule"]
        tables = tuple(torch.as_tensor(t, device=device) for t in steric.tables(
            mol_cfg["z"], mol_cfg["bonds"], margin=setting(cfg, "steric_margin"),
            frames=frames if setting(cfg, "steric_data_margin") else None))
    params = [p for _, p in model.named_parameters()]
    sizes = [p.numel() for p in params]
    start = torch.cat([p.detach().reshape(-1).float() for p in params])
    moment = dict(float32=torch.float32, bfloat16=torch.bfloat16)[cfg["adam_moment_dtype"]]
    mu = torch.zeros(start.numel(), dtype=moment, device=start.device)
    nu = torch.zeros_like(mu)
    gen = torch.Generator(device=device).manual_seed(noise_seed)
    b1, b2, eps, count = 0.9, 0.999, 1e-8, 0
    thresh = cfg["gamma"] * cfg["loss_skip_factor"] if cfg["gamma"] > 0 else math.inf
    out = {"losses": [], "flops": None}
    for k, rows in enumerate(steps):
        share = 1.0
        if fault == "half_batch":
            rows = rows[: len(rows) // 2]
        elif fault == "no_exchange":
            rows, share = rows[: len(rows) // shards], 1.0 / shards
        elif fault is not None:
            raise ValueError(f"unknown fault {fault!r}")
        batch = mol.batch(frames, rows)
        graph = fam.inputs(batch, cfg)
        zeta_k = zeta * min(k / zeta_warmup, 1.0) if zeta_warmup > 0 else zeta
        lr_k = lr * min((k + 1) / lr_warmup, 1.0) if lr_warmup > 0 else lr
        counter = None
        if count_flops and k == 0:
            from torch.utils.flop_counter import FlopCounterMode
            counter = FlopCounterMode(display=False)
            counter.__enter__()
        try:
            loss = share * vae_loss(model(graph, gen), batch.bonds, cfg["beta"], cfg["gamma"],
                                    zeta_k, tables)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        finally:
            if counter is not None:
                counter.__exit__(None, None, None)
                out["flops"] = counter.get_total_flops()
        with torch.no_grad():
            g = torch.cat([(torch.zeros_like(p) if gr is None else gr).reshape(-1).float()
                           for p, gr in zip(params, grads)])
            g_norm = torch.linalg.vector_norm(g)
            ok = bool(torch.isfinite(loss) and loss < thresh and torch.isfinite(g_norm))
            g = torch.where(g_norm < cfg["grad_clip"], g, g / g_norm * cfg["grad_clip"])
            if k == 0:
                out["exact_grad_norms"] = leaf_norms(g, sizes)
            if ok:
                count += 1
                m32 = b1 * mu.float() + (1 - b1) * g
                n32 = b2 * nu.float() + (1 - b2) * g * g
                upd = (m32 / (1 - b1**count)) / (torch.sqrt(n32 / (1 - b2**count)) + eps)
                mu, nu = m32.to(moment), n32.to(moment)
                for p, u in zip(params, torch.split(upd, sizes)):
                    p.add_((-lr_k * u).view_as(p).to(p.dtype))
            if k == 0:
                out["grad_norms"] = leaf_norms(mu.float() / (1 - b1), sizes)
        out["losses"].append(float(loss.detach()))
    with torch.no_grad():
        now = torch.cat([p.detach().reshape(-1).float() for p in params])
        out["change_norms"] = leaf_norms(now - start, sizes)
    out["names"] = [n for n, _ in model.named_parameters()]
    return out
