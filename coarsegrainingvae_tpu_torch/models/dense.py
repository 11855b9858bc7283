"""Dense (padded-batch) equivariant message passing (port of
``coarsegrainingvae_tpu.models.dense``).

Layout: scalars ``(B, N, F)``, vectors ``(B, N, 3, F)``. Two families share
the file:

- ``DenseFactoredEquiMessage``, the dense CGVAE's message, runs the fused
  CUDA kernel (``ops.fused_message``), which rebuilds the pair geometry on
  the card from the node coordinates and mask.
- The DiffPool blocks (``DenseEquiMessageBlock``, ``DenseContract``,
  ``DenseEquiEncoder``, ``DenseCGPrior``, ``DenseEquivariantDecoder``;
  dense.py:66-353 of the JAX package) are plain torch, as the JAX package
  computes them with einsums outside any Pallas kernel: a per-pair
  (B, N, N, S*F) filter over a dense weighted adjacency built from
  ``ops.geometry.dense_pairwise``. A per-pair cross term
  sum_j w_ij (v_i x v_j) is factored as v_i x (sum_j w_ij v_j).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from coarsegrainingvae_tpu_torch.models.conv import UpdateBlock, cross3
from coarsegrainingvae_tpu_torch.models.modules import Dense, DistanceEmbed
from coarsegrainingvae_tpu_torch.ops.fused_message import fused_message
from coarsegrainingvae_tpu_torch.ops.geometry import EPS, dense_pairwise, radius_adjacency


def factored_filter(n_rbf: int, n_split: int, f: int,
                    generator: Optional[torch.Generator] = None,
                    dtype: torch.dtype = torch.float32) -> nn.Parameter:
    """(R+1, S, F) filter weights, initialised like a Xavier Dense over
    (R -> S*F) on the basis rows, with the bias row (last) at zero, stored
    in ``dtype``: the JAX package declares ``filter_w`` in the compute
    dtype (dense.py:433, dense_cgvae.py:117), so at bf16 it trains a bf16
    parameter."""
    limit = math.sqrt(6.0 / (n_rbf + n_split * f))
    w0 = torch.rand(n_rbf, n_split, f, generator=generator) * (2 * limit) - limit
    return nn.Parameter(torch.cat([w0, torch.zeros(1, n_split, f)], dim=0).to(dtype))


class DenseUpdateBlock(nn.Module):
    """UpdateBlock over a padded batch: a per-node op, so a (B*N, ...)
    reshape around it."""

    def __init__(self, feat_dim: int, activation: str,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.update = UpdateBlock(feat_dim, activation, dtype, generator)

    def forward(self, s: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, f = s.shape
        ds, dv = self.update(s.reshape(b * n, f), v.reshape(b * n, 3, f))
        return ds.reshape(b, n, f), dv.reshape(b, n, 3, f)


class DenseFactoredEquiMessage(nn.Module):
    """RBF-factored PaiNN message (dense.py:356-480 of the JAX package).

    The distance filter is linear in the radial basis,
        w_o(d_ij) = env_ij * (sum_r rbf_r(d_ij) W[r, o] + bias_o),
    so the whole pair pipeline runs inside the fused message kernel
    (``ops.fused_message``), which rebuilds the cutoff adjacency from
    (xyz, node_mask, cutoff). The JAX package's three formulations
    (``message_impl`` einsum/qmat/pallas) share this parameter tree; the
    port always takes the kernel.

    ``feature_split`` (``parallel.tensor.FeatureSplit``, set by
    ``split_messages`` under tensor parallelism): the kernel runs on this
    model rank's features only (``local``) and the outputs are gathered
    along F.
    """

    def __init__(self, feat_dim: int, activation: str, n_rbf: int,
                 cutoff: float, cross: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feat_dim
        self.n_split = 4 if cross else 3
        self.feat_dim, self.n_rbf, self.cutoff = f, n_rbf, cutoff
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype,
                            generator=generator)
        self.phi_out = Dense(f, self.n_split * f, dtype=dtype, generator=generator)
        self.filter_w = factored_filter(n_rbf, self.n_split, f, generator, dtype)
        self.feature_split = None

    def forward(self, s: torch.Tensor, v: torch.Tensor, xyz: torch.Tensor,
                node_mask: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        split = self.feature_split
        if split is not None:
            ds, dv = self.local(s, v, xyz, node_mask, split)
            return split.gather(ds), split.gather(dv)
        b, n, f = s.shape
        phi = self.phi_out(self.phi_in(s)).reshape(b, n, self.n_split, f)
        return fused_message(
            xyz.float().contiguous(), node_mask.float().contiguous(),
            phi.float().contiguous(), v.float().contiguous(),
            self.filter_w.float().contiguous(), self.cutoff, self.n_rbf,
        )

    def local(self, s, v, xyz, node_mask, split) -> Tuple[torch.Tensor, torch.Tensor]:
        """(ds, dv) at the features of ``split`` alone: phi_out's columns
        of the slice in each channel, the slices of v and filter_w."""
        phi = split.columns(self.phi_out, split.copy(self.phi_in(s)), self.n_split)
        return fused_message(
            xyz.float().contiguous(), node_mask.float().contiguous(),
            phi.float().contiguous(), split.slice(v.float()),
            split.filter(self.filter_w.float()), self.cutoff, self.n_rbf,
        )


def degree_norm_adjacency(adj: torch.Tensor) -> torch.Tensor:
    """Symmetric deg^-1/2 A deg^-1/2 edge weighting (diffpoolvae.py:390-410
    of the original code)."""
    dinv = rsqrt_safe(torch.sum(adj, dim=-1))
    return adj * dinv[:, :, None] * dinv[:, None, :]


def rsqrt_safe(x: torch.Tensor) -> torch.Tensor:
    """1 / sqrt(max(x, EPS)) where x > 0, else 0 (``jax_rsqrt_safe``)."""
    return torch.where(x > 0, 1.0 / torch.sqrt(torch.clamp(x, min=EPS)), torch.zeros_like(x))


class DenseInvariantMessage(nn.Module):
    """Per-pair invariant filter phi(s_j) x RBF(dist_ij) -> (B, N, N, out):
    the node MLP once on (B, N, F), broadcast against the distance filter."""

    def __init__(self, feat_dim: int, out_feat_dim: int, activation: str, n_rbf: int,
                 cutoff: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phi_in = Dense(feat_dim, feat_dim, activation=activation, dtype=dtype,
                            generator=generator)
        self.phi_out = Dense(feat_dim, out_feat_dim, dtype=dtype, generator=generator)
        self.embed = DistanceEmbed(n_rbf, cutoff, out_feat_dim, dtype, generator)

    def forward(self, s: torch.Tensor, dist: torch.Tensor) -> torch.Tensor:
        phi = self.phi_out(self.phi_in(s))
        return phi[:, None, :, :] * self.embed(dist)     # sender j broadcast over i


class DenseEquiMessageBlock(nn.Module):
    """PaiNN message over a dense weighted adjacency (conv.py:405-484 of the
    original code): adj (B, N, N) carries the connectivity and the edge
    weights; the sums over senders j are einsums."""

    def __init__(self, feat_dim: int, activation: str, n_rbf: int, cutoff: float,
                 cross: bool = False, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feat_dim, self.cross = feat_dim, cross
        self.n_split = 4 if cross else 3
        self.inv = DenseInvariantMessage(feat_dim, self.n_split * feat_dim, activation, n_rbf,
                                         cutoff, dtype, generator)

    def forward(self, s: torch.Tensor, v: torch.Tensor, dist: torch.Tensor,
                unit: torch.Tensor, adj: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.feat_dim
        inv = self.inv(s, dist)
        inv = inv.reshape(inv.shape[:3] + (self.n_split, f)) * adj[..., None, None]
        a, b, c = inv[..., 0, :], inv[..., 1, :], inv[..., 2, :]
        ds = torch.sum(b, dim=2)                                      # (B, N, F)
        dv = (torch.einsum("bijf,bijd->bidf", c, unit)
              + torch.einsum("bijf,bjdf->bidf", a, v))
        if self.cross:
            # sum_j s3_ij (v_i x v_j) = v_i x (sum_j s3_ij v_j)
            w = torch.einsum("bijf,bjdf->bidf", inv[..., 3, :], v)
            bn = v.shape[0] * v.shape[1]
            dv = dv + cross3(v.reshape(bn, 3, f), w.reshape(bn, 3, f)).reshape(v.shape)
        return ds, dv


class DenseContract(nn.Module):
    """Soft atom -> bead contraction (diffpoolvae.py:198-266 of the
    original code): per (bead I, atom i) a Gaussian-offset distance filter
    (offsets ``linspace(0, cutoff, F)``, unit width) times phi(h_i), split
    three ways and aggregated with the soft assignment M."""

    def __init__(self, feat_dim: int, activation: str, cutoff: float,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feat_dim
        self.feat_dim, self.cutoff = f, cutoff
        self.filter = Dense(f, 3 * f, dtype=dtype, generator=generator)
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype, generator=generator)
        self.phi_out = Dense(f, 3 * f, dtype=dtype, generator=generator)

    def forward(self, assign: torch.Tensor, h: torch.Tensor, v: torch.Tensor,
                cg_xyz: torch.Tensor, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.feat_dim
        r_iI = xyz[:, None, :, :] - cg_xyz[:, :, None, :]             # (B, K, N, 3)
        d_iI = torch.sqrt(torch.sum(r_iI**2, dim=-1) + EPS)           # (B, K, N)
        unit = r_iI / d_iI[..., None]
        offsets = torch.linspace(0.0, self.cutoff, f, device=xyz.device).to(xyz.dtype)
        w_s = self.filter(torch.exp(-((d_iI[..., None] - offsets) ** 2)))   # (B, K, N, 3F)
        phi = self.phi_out(self.phi_in(h))                            # (B, N, 3F)
        filt = (w_s * phi[:, None, :, :]).reshape(w_s.shape[:3] + (3, f))
        m_t = assign.transpose(1, 2)                                  # (B, K, N)
        s0 = filt[..., 0, :] * m_t[..., None]
        s2 = filt[..., 2, :] * m_t[..., None]
        dV = (torch.einsum("bkif,bkid->bkdf", s2, unit)
              + torch.einsum("bkif,bidf->bkdf", s0, v))
        dH = torch.einsum("bkif,bki->bkf", filt[..., 1, :], m_t)
        return dH, dV


class DenseEquiEncoder(nn.Module):
    """Padded-batch atom encoder with a soft contraction per layer
    (diffpoolvae.py:269-353 of the original code): the atom graph is the
    radius adjacency of the coordinates; the atom residuals are scaled by
    0.5, as in the original code."""

    def __init__(self, n_conv: int, feat_dim: int, n_rbf: int, activation: str,
                 cutoff: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cutoff = cutoff
        self.msgs = nn.ModuleList(
            DenseEquiMessageBlock(feat_dim, activation, n_rbf, cutoff, dtype=dtype,
                                  generator=generator) for _ in range(n_conv))
        self.updates = nn.ModuleList(
            DenseUpdateBlock(feat_dim, activation, dtype, generator) for _ in range(n_conv))
        self.contract = nn.ModuleList(
            DenseContract(feat_dim, activation, cutoff, dtype, generator) for _ in range(n_conv))

    def forward(self, h: torch.Tensor, H: torch.Tensor, xyz: torch.Tensor,
                cg_xyz: torch.Tensor, assign: torch.Tensor,
                atom_mask: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
        _, dist, unit = dense_pairwise(xyz)
        adj = radius_adjacency(dist, self.cutoff, atom_mask)
        v = h.new_zeros(h.shape[:2] + (3, h.shape[-1]))
        V = H.new_zeros(H.shape[:2] + (3, H.shape[-1]))
        for msg, update, contract in zip(self.msgs, self.updates, self.contract):
            ds, dv = msg(h, v, dist, unit, adj)
            h, v = h + 0.5 * ds, v + 0.5 * dv
            ds, dv = update(h, v)
            h, v = h + 0.5 * ds, v + 0.5 * dv
            dH, dV = contract(assign, h, v, cg_xyz, xyz)
            H, V = H + dH, V + dV
        return H, V


class _DenseCGStack(nn.Module):
    """Message and update blocks over the degree-normalised CG graph, full
    residuals: the trunk of the prior and of the decoder."""

    def __init__(self, n_conv: int, feat_dim: int, n_rbf: int, activation: str,
                 cutoff: float, cross: bool, dtype: torch.dtype,
                 generator: Optional[torch.Generator]):
        super().__init__()
        self.msgs = nn.ModuleList(
            DenseEquiMessageBlock(feat_dim, activation, n_rbf, cutoff, cross, dtype, generator)
            for _ in range(n_conv))
        self.updates = nn.ModuleList(
            DenseUpdateBlock(feat_dim, activation, dtype, generator) for _ in range(n_conv))

    def trunk(self, H: torch.Tensor, cg_adj: torch.Tensor,
              cg_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, dist, unit = dense_pairwise(cg_xyz)
        adj = degree_norm_adjacency(cg_adj)
        V = H.new_zeros(H.shape[:2] + (3, H.shape[-1]))
        for msg, update in zip(self.msgs, self.updates):
            dH, dV = msg(H, V, dist, unit, adj)
            H, V = H + dH, V + dV
            dH, dV = update(H, V)
            H, V = H + dH, V + dV
        return H, V


class DenseCGPrior(_DenseCGStack):
    """The conditional prior over the dense CG graph (diffpoolvae.py:356-429
    of the original code): (mu, sigma) of every bead."""

    def __init__(self, n_conv: int, feat_dim: int, n_rbf: int, activation: str,
                 cutoff: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_conv, feat_dim, n_rbf, activation, cutoff, False, dtype, generator)
        f = feat_dim
        self.mu_in = Dense(f, f, activation="Tanh", dtype=dtype, generator=generator)
        self.mu_out = Dense(f, f, dtype=dtype, generator=generator)
        self.logvar_in = Dense(f, f, activation="Tanh", dtype=dtype, generator=generator)
        self.logvar_out = Dense(f, f, dtype=dtype, generator=generator)

    def forward(self, H: torch.Tensor, cg_adj: torch.Tensor,
                cg_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        H, _ = self.trunk(H, cg_adj, cg_xyz)
        mu = self.mu_out(self.mu_in(H))
        logvar = torch.clamp(self.logvar_out(self.logvar_in(H)), -30.0, 30.0)
        return mu, 1e-9 + torch.exp(logvar / 2.0)


class DenseEquivariantDecoder(_DenseCGStack):
    """CG-graph decoder and its learned channel pooler
    (diffpoolvae.py:432-513 of the original code): a trainable (n_atoms, F)
    matrix maps each bead's F vector channels to per-atom displacement
    candidates, V_dec[b, I, n] = sum_f V[b, I, :, f] pooler[n, f]."""

    def __init__(self, n_atoms: int, feat_dim: int, n_rbf: int, activation: str,
                 cutoff: float, n_conv: int, cross: bool = True,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_conv, feat_dim, n_rbf, activation, cutoff, cross, dtype, generator)
        # in the compute dtype, as the JAX package declares it (dense.py:348)
        self.channel_pooler = nn.Parameter(
            torch.randn(n_atoms, feat_dim, generator=generator).to(dtype))

    def forward(self, H: torch.Tensor, cg_adj: torch.Tensor,
                cg_xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        H, V = self.trunk(H, cg_adj, cg_xyz)
        pooler = self.channel_pooler.to(V.dtype)
        return H, torch.einsum("bkdf,nf->bknd", V, pooler)            # (B, K, N, 3)
