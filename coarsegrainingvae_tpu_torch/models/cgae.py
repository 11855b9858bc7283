"""Learned CG mapping, ``cg_method='cgae'`` (port of
``coarsegrainingvae_tpu.models.cgae``).

A tiny mapping autoencoder (cgae.py:8-33 and learn_map, datasets.py:190-249
of the original code): an (n_atoms, n_cgs) assignment-logit matrix encodes
atoms to beads through a gumbel-softmax; an (n_atoms, n_cgs) linear decoder
lifts the bead coordinates back to atoms. The loss is the reconstruction MSE
plus ``reg`` times the MSE of the atoms against their soft-assigned bead
centres; tau anneals 1.0 -> 0.025 at 0.001 per step; Adam at lr 4e-3 for
1,500 steps. The hard mapping is the argmax of the learned logits.

The JAX package runs the optimisation as one ``lax.scan``; here it is a
torch loop on ``device`` (the card unless the caller passes "cpu"), with the
frames resident there. ``learn_map_core`` takes the initial parameters and
each step's batch indices and uniform noise, so the same trajectory can be
driven from noise drawn elsewhere; ``learn_map`` draws them, step by step,
from generators seeded through ``utils.rng.fold_in``.
"""
from __future__ import annotations

import math
from typing import Iterable, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.utils.rng import generator as derived_generator

# jax.random.uniform's bounds in gumbel_softmax (cgae.py:39)
U_MIN, U_MAX = 1e-10, 1.0


def uniform_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Uniform noise in [1e-10, 1), as jax.random.uniform(minval=1e-10)
    maps its [0, 1) draw."""
    r = torch.rand(shape, generator=generator, device=device)
    return torch.clamp_min(r * (U_MAX - U_MIN) + U_MIN, U_MIN)


def gumbel_softmax(logits: torch.Tensor, tau, u: torch.Tensor,
                   hard: bool = False) -> torch.Tensor:
    """Gumbel-softmax sample along the last axis from the uniform noise
    ``u`` (logits' shape): softmax((logits + g) / tau), g = -log(-log(u));
    ``hard`` gives the straight-through one-hot."""
    g = -torch.log(-torch.log(u))
    y = torch.softmax((logits + g) / tau, dim=-1)
    if hard:
        idx = torch.argmax(y, dim=-1)
        y_hard = torch.nn.functional.one_hot(idx, logits.shape[-1]).to(y.dtype)
        y = y_hard - y.detach() + y
    return y


def cgae_forward(assign_logits: torch.Tensor, decode: torch.Tensor, xyz: torch.Tensor,
                 u: torch.Tensor, tau) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One autoencoding pass over (B, N, 3) mean-centred frames with noise
    u (B, N, K): (x_recon (B, N, 3), cg_xyz (B, K, 3), the soft assignment
    M (B, N, K))."""
    b = xyz.shape[0]
    m = gumbel_softmax(assign_logits.expand((b,) + tuple(assign_logits.shape)), tau, u)
    # bead coordinates: the assignment-weighted atom mean (cgae.py:25-28)
    weights = m / (torch.sum(m, dim=1, keepdim=True) + 1e-8)
    cg_xyz = torch.einsum("bnk,bnd->bkd", weights, xyz)
    x_recon = torch.einsum("nk,bkd->bnd", decode, cg_xyz)
    return x_recon, cg_xyz, m


def anneal_tau(step: int, tau_start: float, tau_min: float, tau_rate: float) -> float:
    """max(tau_start - tau_rate * step, tau_min) in float32, as the JAX loop
    computes it from its float32 step index."""
    f32 = np.float32
    return float(max(f32(tau_start) - f32(tau_rate) * f32(step), f32(tau_min)))


def learn_map_core(
    data: torch.Tensor,                  # (F, N, 3) mean-centred frames
    assign_logits: torch.Tensor,         # (N, K) initial logits
    decode: torch.Tensor,                # (N, K) initial decoder
    steps: Iterable[Tuple[torch.Tensor, torch.Tensor]],
    lr: float = 4e-3,
    tau_start: float = 1.0,
    tau_min: float = 0.025,
    tau_rate: float = 0.001,
    reg: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The optimisation loop: one Adam step (optax.adam's constants) per
    item of ``steps``, each (frame indices (B,), uniform noise (B, N, K)).
    Returns the final (assign_logits, decode) on the data's device."""
    b1, b2, eps = 0.9, 0.999, 1e-8
    params = [assign_logits.detach().clone().requires_grad_(True),
              decode.detach().clone().requires_grad_(True)]
    mu = [torch.zeros_like(p) for p in params]
    nu = [torch.zeros_like(p) for p in params]
    for i, (idx, u) in enumerate(steps):
        tau = anneal_tau(i, tau_start, tau_min, tau_rate)
        batch = data.index_select(0, idx)
        x_recon, cg_xyz, m = cgae_forward(params[0], params[1], batch, u, tau)
        recon = torch.mean((x_recon - batch) ** 2)
        # shift regulariser: atoms close to their assigned bead centre
        lifted = torch.einsum("bnk,bkd->bnd", m, cg_xyz)
        loss = recon + reg * torch.mean((lifted - batch) ** 2)
        grads = torch.autograd.grad(loss, params)
        # optax's bias corrections, in float32 as its int32 count gives them
        count = np.float32(i + 1)
        c1 = float(np.float32(1) - np.float32(b1) ** count)
        c2 = float(np.float32(1) - np.float32(b2) ** count)
        with torch.no_grad():
            for p, g, m1, m2 in zip(params, grads, mu, nu):
                m1.mul_(b1).add_((1 - b1) * g)
                m2.mul_(b2).add_((1 - b2) * (g * g))
                m_hat = m1 / c1
                v_hat = m2 / c2
                p.add_(-lr * (m_hat / (torch.sqrt(v_hat) + eps)))
    return params[0].detach(), params[1].detach()


def hard_mapping(assign_logits) -> np.ndarray:
    """argmax of the logits, relabelled to consecutive bead ids by first
    occurrence (cgae.py:133-142)."""
    raw = np.asarray(torch.as_tensor(assign_logits).detach().cpu().numpy()).argmax(-1)
    remap: dict = {}
    out = np.empty(raw.shape[0], dtype=np.int32)
    for i, label in enumerate(raw):
        if label not in remap:
            remap[label] = len(remap)
        out[i] = remap[label]
    return out


def centred_frames(frames: np.ndarray, max_frames: int = 2000) -> np.ndarray:
    """The first ``max_frames`` frames in float32, each mean-centred."""
    frames = np.asarray(frames, dtype=np.float32)[:max_frames]
    return frames - frames.mean(axis=1, keepdims=True)


def learn_map(
    frames: np.ndarray,
    n_cgs: int,
    n_steps: int = 1500,
    lr: float = 4e-3,
    batch_size: int = 32,
    tau_start: float = 1.0,
    tau_min: float = 0.025,
    tau_rate: float = 0.001,
    reg: float = 1.0,
    seed: int = 0,
    max_frames: int = 2000,
    device="cuda",
) -> np.ndarray:
    """Train the mapping autoencoder on ``device`` and return the hard (N,)
    mapping. The initial logits (normal x 0.1) and decoder (normal /
    sqrt(n_cgs)) come from generators seeded from (seed, 0) and (seed, 1);
    each step draws its batch indices and noise from one generator seeded
    from (seed, 2), on the device, one step at a time."""
    frames = centred_frames(frames, max_frames)
    f, n, _ = frames.shape
    batch_size = min(batch_size, f)
    data = torch.as_tensor(frames).to(device)
    assign_logits = torch.randn((n, n_cgs), generator=derived_generator(device, seed, 0),
                                device=device) * 0.1
    decode = torch.randn((n, n_cgs), generator=derived_generator(device, seed, 1),
                         device=device) * (1.0 / math.sqrt(n_cgs))
    gen = derived_generator(device, seed, 2)

    def draws():
        for _ in range(n_steps):
            idx = torch.randint(0, f, (batch_size,), generator=gen, device=device)
            yield idx, uniform_noise((batch_size, n, n_cgs), gen, device)

    logits, _ = learn_map_core(data, assign_logits, decode, draws(), lr=lr,
                               tau_start=tau_start, tau_min=tau_min,
                               tau_rate=tau_rate, reg=reg)
    return hard_mapping(logits)
