"""DiffPoolVAE: learned soft coarse-graining and a dense VAE (port of
``coarsegrainingvae_tpu.models.diffpool``; diffpoolvae.py:8-195 of the
original code).

The pooler learns the CG mapping end to end: a small bond-graph conv stack
and, by default, one trainable (n_atoms, n_cgs) logit matrix, sampled with
a gumbel-softmax at an annealed temperature. The VAE around it runs in the
padded dense regime of ``models/dense.py``, in plain torch (the JAX package
runs it through no Pallas kernel).

Noise. The JAX package draws the gumbel noise and the reparametrisation
noise inside its flax modules; torch streams cannot reproduce them. Here
``forward`` and ``sample`` take the uniform draw ``u`` (the logits' shape:
(N, K) for the shared trainable map, (B, N, K) for per-atom logits) and the
normal draw ``eps`` ((B, K, F)) as optional inputs, and otherwise draw them
from ``generator``: u first, then eps.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from coarsegrainingvae_tpu_torch.config import DiffPoolConfig
from coarsegrainingvae_tpu_torch.models.cgae import gumbel_softmax, uniform_noise
from coarsegrainingvae_tpu_torch.models.dense import (
    DenseCGPrior,
    DenseEquiEncoder,
    DenseEquivariantDecoder,
)
from coarsegrainingvae_tpu_torch.models.modules import MLP, EmbeddingZeroPad

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclass
class PoolOutput:
    """Everything the pooler derives from one batch (diffpoolvae.py:195)."""

    assign: torch.Tensor       # (B, N, K) soft assignment M
    assign_norm: torch.Tensor  # (B, N, K) column-normalised M
    h: torch.Tensor            # (B, N, F) atom features after the bond convs
    H: torch.Tensor            # (B, K, F) bead features M_norm^T h
    adj: torch.Tensor          # (B, N, N) bond adjacency
    cg_xyz: torch.Tensor       # (B, K, 3) soft bead coordinates
    cg_adj: torch.Tensor       # (B, K, K) the complete CG graph minus its diagonal


@dataclass
class DiffPoolOutput:
    xyz: torch.Tensor          # (B, N, 3) centred input coordinates
    xyz_recon: torch.Tensor    # (B, N, 3)
    assign: torch.Tensor       # (B, N, K)
    cg_xyz: torch.Tensor       # (B, K, 3)
    mu: torch.Tensor           # (B, K, F) posterior
    sigma: torch.Tensor
    prior_mu: torch.Tensor
    prior_sigma: torch.Tensor


def bond_adjacency(bonds: torch.Tensor, n_atoms: int) -> torch.Tensor:
    """(Eb, 2) undirected bond list -> symmetric (N, N) 0/1 adjacency."""
    adj = torch.zeros((n_atoms, n_atoms), dtype=torch.float32, device=bonds.device)
    adj[bonds[:, 0], bonds[:, 1]] = 1.0
    adj[bonds[:, 1], bonds[:, 0]] = 1.0
    return adj


def _one_hot(idx: torch.Tensor, k: int, dtype: torch.dtype) -> torch.Tensor:
    return nn.functional.one_hot(idx, k).to(dtype)


class CGpool(nn.Module):
    """Soft CG assignment network (diffpoolvae.py:105-195 of the original
    code), in one of three modes:

    * ``assign_idx`` given: a fixed one-hot assignment;
    * ``trainable_map``: one trainable (N, K) logit matrix shared by the
      batch, gumbel-sampled per call (the DiffPool driver's mode);
    * otherwise per-atom logits from the conv features.

    ``hard=True`` takes the argmax assignment (the noise-free tau -> 0
    limit), which generative sampling uses so that a near tie cannot move
    an atom to a distant bead between draws."""

    def __init__(self, n_conv: int, feat_dim: int, n_atoms: int, n_cgs: int,
                 assign_idx: Optional[Sequence[int]] = None, trainable_map: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_cgs = n_cgs
        self.trainable_map = assign_idx is None and trainable_map
        self.embed = EmbeddingZeroPad(100, feat_dim, generator)
        self.convs = nn.ModuleList(
            MLP(feat_dim, [feat_dim, feat_dim], activation="Tanh", dtype=dtype,
                generator=generator) for _ in range(n_conv))
        self.register_buffer("assign_idx", None if assign_idx is None else torch.as_tensor(
            np.asarray(assign_idx, np.int64)), persistent=False)
        if self.trainable_map:
            # in the compute dtype, as the JAX package declares it (diffpool.py:107)
            self.assign_map = nn.Parameter(
                torch.randn(n_atoms, n_cgs, generator=generator).to(dtype))
        elif assign_idx is None:
            self.logits = MLP(feat_dim, [feat_dim, n_cgs], activation="Tanh", dtype=dtype,
                              generator=generator)

    def noise_shape(self, batch: int, n_atoms: int) -> Optional[tuple]:
        """The shape of the uniform draw, None for the fixed mapping."""
        if self.assign_idx is not None:
            return None
        return (n_atoms, self.n_cgs) if self.trainable_map else (batch, n_atoms, self.n_cgs)

    def forward(self, z: torch.Tensor, xyz: torch.Tensor, adj: torch.Tensor, tau,
                hard: bool = False, u: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> PoolOutput:
        h = self.embed(z)
        # receiver-degree-normalised bond convs (diffpoolvae.py:158-169)
        deg = torch.sum(adj, dim=-1, keepdim=True)
        for conv in self.convs:
            h = h + torch.einsum("bif,bij->bjf", conv(h), adj) / torch.clamp(deg, min=1.0)

        b = h.shape[0]
        if self.assign_idx is not None:
            m = _one_hot(self.assign_idx, self.n_cgs, h.dtype).expand(b, -1, -1)
        else:
            logits = self.assign_map if self.trainable_map else self.logits(h)
            if hard:
                m = _one_hot(torch.argmax(logits, -1), self.n_cgs, h.dtype)
            else:
                if u is None:
                    u = uniform_noise(self.noise_shape(b, h.shape[1]), generator, h.device)
                m = gumbel_softmax(logits, tau, u)
            if self.trainable_map:
                m = m.expand(b, -1, -1)

        m_norm = m / (torch.sum(m, dim=1, keepdim=True) + 1e-8)
        H = torch.einsum("bnk,bnf->bkf", m_norm, h)
        cg_xyz = torch.einsum("bnd,bnk->bkd", xyz, m_norm)
        k = self.n_cgs
        cg_adj = (torch.ones((b, k, k), dtype=h.dtype, device=h.device)
                  - torch.eye(k, dtype=h.dtype, device=h.device))
        return PoolOutput(assign=m, assign_norm=m_norm, h=h, H=H, adj=adj, cg_xyz=cg_xyz,
                          cg_adj=cg_adj)


def _lift(out_v: torch.Tensor, pool: PoolOutput) -> torch.Tensor:
    """Per-(bead, atom) displacement channels -> atom positions, with the
    soft centre-of-mass re-centring (``_lift``, diffpoolvae.py:96-101)."""
    dx = torch.einsum("bnk,bknd->bnd", pool.assign, out_v)
    cg_offset = torch.einsum("bnd,bnk->bkd", dx, pool.assign_norm)
    offset_lift = torch.einsum("bkd,bnk->bnd", cg_offset, pool.assign)
    anchor = torch.einsum("bkd,bnk->bnd", pool.cg_xyz, pool.assign)
    return anchor - offset_lift + dx


class DiffPoolVAE(nn.Module):
    """The whole model (diffpoolvae.py:8-103 of the original code): pool ->
    prior -> encode -> mu/sigma -> reparametrise -> decode -> soft channel
    lift. Parameters are drawn on the CPU from ``generator``; move the
    model with ``.to(device)``."""

    def __init__(self, cfg: DiffPoolConfig, assign_idx: Optional[Sequence[int]] = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        dtype = _DTYPES[c.compute_dtype]
        self.pooler = CGpool(c.pool_nconv, c.feat_dim, c.n_atoms, c.n_cgs, assign_idx,
                             c.trainable_map and assign_idx is None, dtype, generator)
        self.prior_net = DenseCGPrior(c.enc_nconv, c.feat_dim, c.n_rbf, c.activation,
                                      c.cg_cutoff, dtype, generator)
        self.encoder = DenseEquiEncoder(c.enc_nconv, c.feat_dim, c.n_rbf, c.activation,
                                        c.atom_cutoff, dtype, generator)
        self.decoder = DenseEquivariantDecoder(c.n_atoms, c.feat_dim, c.n_rbf, c.activation,
                                               c.cg_cutoff, c.dec_nconv, c.cross, dtype,
                                               generator)
        self.atom_munet = MLP(c.feat_dim, [c.feat_dim, c.feat_dim], activation="ReLU",
                              dtype=dtype, generator=generator)
        self.atom_sigmanet = MLP(c.feat_dim, [c.feat_dim, c.feat_dim], activation="ReLU",
                                 dtype=dtype, generator=generator)

    def _normal(self, like: torch.Tensor, eps: Optional[torch.Tensor],
                generator: Optional[torch.Generator]) -> torch.Tensor:
        if eps is not None:
            return eps
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=like.dtype)

    def forward(self, z: torch.Tensor, xyz: torch.Tensor, adj: torch.Tensor, tau,
                u: Optional[torch.Tensor] = None, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> DiffPoolOutput:
        xyz = xyz - torch.mean(xyz, dim=1, keepdim=True)             # diffpoolvae.py:65
        pool = self.pooler(z, xyz, adj, tau, u=u, generator=generator)
        prior_mu, prior_sigma = self.prior_net(pool.H, pool.cg_adj, pool.cg_xyz)
        H_z, _ = self.encoder(pool.h, pool.H, xyz, pool.cg_xyz, pool.assign)
        mu = self.atom_munet(H_z)
        logvar = torch.clamp(self.atom_sigmanet(H_z), -30.0, 30.0)
        sigma = 1e-9 + torch.exp(logvar / 2.0)
        h_repar = mu if self.cfg.det else mu + sigma * self._normal(mu, eps, generator)
        _, out_v = self.decoder(h_repar, pool.cg_adj, pool.cg_xyz)
        return DiffPoolOutput(xyz=xyz, xyz_recon=_lift(out_v, pool), assign=pool.assign,
                              cg_xyz=pool.cg_xyz, mu=mu, sigma=sigma, prior_mu=prior_mu,
                              prior_sigma=prior_sigma)

    def sample(self, z: torch.Tensor, xyz: torch.Tensor, adj: torch.Tensor, tau,
               hard: bool = False, u: Optional[torch.Tensor] = None,
               eps: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Generative sampling from the conditional prior
        (diffpoolvae.py:26-58); like the JAX package, it pools the
        coordinates as given, without centring them."""
        pool = self.pooler(z, xyz, adj, tau, hard=hard, u=u, generator=generator)
        prior_mu, prior_sigma = self.prior_net(pool.H, pool.cg_adj, pool.cg_xyz)
        h = prior_mu + prior_sigma * self._normal(prior_mu, eps, generator)
        _, out_v = self.decoder(h, pool.cg_adj, pool.cg_xyz)
        return _lift(out_v, pool)


def tau_schedule(step: int, tau_0: float, tau_min: float, tau_rate: float) -> float:
    """Exponential gumbel temperature anneal (run_diffpool.py:357-358),
    (tau_0 - tau_min) * exp(-tau_rate * step) + tau_min in float32, as the
    JAX package computes it from its float32 step."""
    f32 = np.float32
    return float((f32(tau_0) - f32(tau_min)) * np.exp(-f32(tau_rate) * f32(step))
                 + f32(tau_min))
