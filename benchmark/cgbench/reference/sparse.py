"""Plain reference of the sparse CGequiVAE (the port's ``models/cgvae.py``
``CGequiVAE``).

A frozen copy of the port's plain code at commit add70c80
(``models/cgvae.py``: ``EquiEncoder``, ``CGprior``, ``EquivariantDecoder``,
``EquivariantPseudoDecoder``, ``lift_channels``, ``CGequiVAE.forward``;
``models/conv.py``: ``InvariantMessage``, ``EquiMessageBlock``,
``EquiMessageCross``, ``EquiMessagePseudo``, ``ContractiveMessageBlock``),
on a flat graph of exact edge lists (no padding) with ``index_add`` sums.
The decoder is the pseudo one, the cross one or the PaiNN one, as
``dec_type`` says. Parameter names are the port's. Imports nothing of the
port.

The family's interface to the harness: ``Model``, ``inputs`` (the flat
graph of a batch, its edges worked out again from the coordinates) and
``KEYS``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from cgbench.reference import dense
from cgbench.reference.dense import VAEOutput, draw_eps
from cgbench.reference.layers import (
    MLP,
    Dense,
    DistanceEmbed,
    EmbeddingZeroPad,
    UpdateBlock,
    cross3,
    dtype_of,
    preprocess_r,
    segment_mean,
    segment_sum,
)


KEYS = dense.KEYS       # the dense family's model keys
DECODERS = ("pseudo", "cross", "painn")


@dataclass
class FlatGraph:
    z: torch.Tensor
    xyz: torch.Tensor
    cg_z: torch.Tensor
    cg_xyz: torch.Tensor
    mapping: torch.Tensor        # global bead ids
    channel_idx: torch.Tensor
    nbrs: torch.Tensor           # (E, 2) global, every pair within the cutoff
    cg_nbrs: torch.Tensor
    num_nodes: int
    num_cg: int


def radius_edges(xyz: torch.Tensor, cutoff: float) -> torch.Tensor:
    """(E, 2) global (receiver, sender) pairs with distance <= cutoff, of
    (B, K, 3) coordinates."""
    b, k, _ = xyz.shape
    d2 = torch.sum((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2, dim=-1)
    adj = (d2 <= cutoff * cutoff) & ~torch.eye(k, dtype=torch.bool, device=xyz.device)
    f, i, j = torch.nonzero(adj, as_tuple=True)
    return torch.stack([f * k + i, f * k + j], dim=1)


def inputs(batch, cfg: dict) -> FlatGraph:
    """The flat graph of a padded batch (every mask one)."""
    b, n = batch.z.shape
    m = batch.cg_z.shape[1]
    beads = torch.arange(b, device=batch.z.device)[:, None] * m
    return FlatGraph(z=batch.z.reshape(-1), xyz=batch.xyz.reshape(-1, 3),
                     cg_z=batch.cg_z.reshape(-1), cg_xyz=batch.cg_xyz.reshape(-1, 3),
                     mapping=(batch.mapping + beads).reshape(-1),
                     channel_idx=batch.channel_idx.reshape(-1),
                     nbrs=radius_edges(batch.xyz, cfg["atom_cutoff"]),
                     cg_nbrs=radius_edges(batch.cg_xyz, cfg["cg_cutoff"]), num_nodes=b * n,
                     num_cg=b * m)


def edge_vectors(xyz: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    return xyz[edges[:, 1]] - xyz[edges[:, 0]]


class InvariantMessage(nn.Module):
    def __init__(self, in_dim, out_dim, activation, n_rbf, cutoff, dtype):
        super().__init__()
        self.phi_in = Dense(in_dim, in_dim, activation=activation, dtype=dtype)
        self.phi_out = Dense(in_dim, out_dim, dtype=dtype)
        self.embed = DistanceEmbed(n_rbf, cutoff, out_dim, dtype)

    def forward(self, s, dist, edges):
        phi = self.phi_out(self.phi_in(s))
        return phi[edges[:, 1]] * self.embed(dist)


class _EdgeBlock(nn.Module):
    def __init__(self, feat_dim, activation, n_rbf, cutoff, n_split, dtype):
        super().__init__()
        self.feat_dim, self.n_split = feat_dim, n_split
        self.inv = InvariantMessage(feat_dim, n_split * feat_dim, activation, n_rbf, cutoff,
                                    dtype)

    def split(self, s, r_ij, edges):
        dist, unit = preprocess_r(r_ij)
        return self.inv(s, dist, edges).reshape(-1, self.n_split, self.feat_dim), unit


class EquiMessageBlock(_EdgeBlock):
    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 3, dtype)

    def forward(self, s, v, r_ij, edges):
        inv, unit = self.split(s, r_ij, edges)
        a, b, c = inv[:, 0], inv[:, 1], inv[:, 2]
        dv_ij = c[:, None, :] * unit[:, :, None] + a[:, None, :] * v[edges[:, 1]]
        n = s.shape[0]
        return segment_sum(b, edges[:, 0], n), segment_sum(dv_ij, edges[:, 0], n)


class EquiMessageCross(_EdgeBlock):
    """The PaiNN message plus the v_i x v_j term, a 4-way split."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 4, dtype)

    def forward(self, s, v, r_ij, edges):
        inv, unit = self.split(s, r_ij, edges)
        s0, s1, s2, s3 = inv[:, 0], inv[:, 1], inv[:, 2], inv[:, 3]
        v_i, v_j = v[edges[:, 0]], v[edges[:, 1]]
        dv_ij = (s2[:, None, :] * unit[:, :, None] + s0[:, None, :] * v_j
                 + s3[:, None, :] * cross3(v_i, v_j))
        n = s.shape[0]
        return segment_sum(s1, edges[:, 0], n), segment_sum(dv_ij, edges[:, 0], n)


class EquiMessagePseudo(_EdgeBlock):
    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 9, dtype)

    def forward(self, s, sbar, v, vbar, r_ij, edges):
        inv, unit = self.split(s, r_ij, edges)
        sp = [inv[:, k] for k in range(9)]
        i_idx, j_idx = edges[:, 0], edges[:, 1]
        s_i, sbar_i = s[i_idx], sbar[i_idx]
        v_i, v_j = v[i_idx], v[j_idx]
        vbar_i, vbar_j = vbar[i_idx], vbar[j_idx]
        ds_ij = sp[0] * s_i
        dsbar_ij = torch.sum(v_i * vbar_j, dim=1)
        dv_ij = (sp[1][:, None, :] * unit[:, :, None] + sp[2][:, None, :] * v_j
                 + sp[3][:, None, :] * cross3(v_i, vbar_j)
                 + sp[4][:, None, :] * sbar_i[:, None, :] * vbar_j)
        dvbar_ij = (sp[5][:, None, :] * vbar_j + sp[6][:, None, :] * sbar_i[:, None, :] * v_j
                    + sp[7][:, None, :] * cross3(v_i, v_j)
                    + sp[8][:, None, :] * cross3(vbar_i, vbar_j))
        n = s.shape[0]
        return tuple(segment_sum(t, i_idx, n) for t in (ds_ij, dsbar_ij, dv_ij, dvbar_ij))


class ContractiveMessageBlock(nn.Module):
    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype):
        super().__init__()
        f = feat_dim
        self.feat_dim = f
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype)
        self.phi_out = Dense(f, 3 * f, dtype=dtype)
        self.embed = DistanceEmbed(n_rbf, cutoff, 3 * f, dtype)

    def forward(self, s, v, r_iI, mapping, num_cg):
        dist, unit = preprocess_r(r_iI)
        phi = self.phi_out(self.phi_in(s))
        inv = (phi * self.embed(dist)).reshape(-1, 3, self.feat_dim)
        a, b, c = inv[:, 0], inv[:, 1], inv[:, 2]
        dv_iI = c[:, None, :] * unit[:, :, None] + a[:, None, :] * v
        return segment_sum(b, mapping, num_cg), segment_sum(dv_iI, mapping, num_cg)


class EquiEncoder(nn.Module):
    def __init__(self, n_conv, f, n_rbf, activation, cutoff, contract_cutoff, dtype):
        super().__init__()
        self.feat_dim = f
        self.embed = EmbeddingZeroPad(100, f)
        self.msgs = nn.ModuleList(EquiMessageBlock(f, activation, n_rbf, cutoff, dtype)
                                  for _ in range(n_conv))
        self.contract = nn.ModuleList(
            ContractiveMessageBlock(f, activation, n_rbf, contract_cutoff, dtype)
            for _ in range(n_conv))

    def forward(self, g):
        h = self.embed(g.z)
        v = torch.zeros((g.num_nodes, 3, self.feat_dim), dtype=h.dtype, device=h.device)
        r_ij = edge_vectors(g.xyz, g.nbrs)
        r_iI = g.xyz - g.cg_xyz[g.mapping]
        H = V = None
        for i, (msg, contract) in enumerate(zip(self.msgs, self.contract)):
            ds, dv = msg(h, v, r_ij, g.nbrs)
            h, v = h + ds, v + dv
            if i == 0:
                H = segment_mean(h, g.mapping, g.num_cg)
                V = segment_mean(v, g.mapping, g.num_cg)
            dH, dV = contract(h, v, r_iI, g.mapping, g.num_cg)
            H, V = H + dH, V + dV
        return H


class CGprior(nn.Module):
    def __init__(self, n_conv, f, n_rbf, activation, cutoff, vocab, dtype):
        super().__init__()
        self.feat_dim = f
        self.embed = EmbeddingZeroPad(vocab, f)
        self.msgs = nn.ModuleList(EquiMessageBlock(f, activation, n_rbf, cutoff, dtype)
                                  for _ in range(n_conv))
        self.mu = MLP(f, [f, f], activation="Tanh", dtype=dtype)
        self.logvar = MLP(f, [f, f], activation="Tanh", dtype=dtype)

    def forward(self, g):
        h = self.embed(g.cg_z)
        v = torch.zeros((g.num_cg, 3, self.feat_dim), dtype=h.dtype, device=h.device)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for msg in self.msgs:
            ds, dv = msg(h, v, r_ij, g.cg_nbrs)
            h, v = h + ds, v + dv
        logvar = torch.clamp(self.logvar(h), -30.0, 30.0)
        return self.mu(h), 1e-9 + torch.exp(logvar / 2.0)


class EquivariantDecoder(nn.Module):
    """The cross (``cross``) or PaiNN message blocks, each followed by an
    UpdateBlock."""

    def __init__(self, f, n_rbf, cutoff, num_conv, activation, cross, dtype):
        super().__init__()
        self.feat_dim = f
        block = EquiMessageCross if cross else EquiMessageBlock
        self.msgs = nn.ModuleList(block(f, activation, n_rbf, cutoff, dtype)
                                  for _ in range(num_conv))
        self.updates = nn.ModuleList(UpdateBlock(f, activation, dtype) for _ in self.msgs)

    def forward(self, g, S):
        H = S
        V = torch.zeros((S.shape[0], 3, self.feat_dim), dtype=S.dtype, device=S.device)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for msg, upd in zip(self.msgs, self.updates):
            dH, dV = msg(H, V, r_ij, g.cg_nbrs)
            H, V = H + dH, V + dV
            dH, dV = upd(H, V)
            H, V = H + dH, V + dV
        return H, V


class EquivariantPseudoDecoder(nn.Module):
    def __init__(self, f, n_rbf, cutoff, num_conv, activation, breaksym, dtype):
        super().__init__()
        self.feat_dim, self.breaksym = f, breaksym
        self.msgs = nn.ModuleList(EquiMessagePseudo(f, activation, n_rbf, cutoff, dtype)
                                  for _ in range(num_conv))
        self.updates = nn.ModuleList(UpdateBlock(f, activation, dtype) for _ in self.msgs)

    def forward(self, g, S):
        V = torch.zeros((S.shape[0], 3, self.feat_dim), dtype=S.dtype, device=S.device)
        Vbar = torch.zeros_like(V)
        Sbar = torch.ones_like(S) if self.breaksym else torch.zeros_like(S)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for msg, upd in zip(self.msgs, self.updates):
            dS, dSbar, dV, dVbar = msg(S, Sbar, V, Vbar, r_ij, g.cg_nbrs)
            Sbar, Vbar = Sbar + dSbar, Vbar + dVbar
            S, V = S + dS, V + dV
            dS, dV = upd(S, V)
            S, V = S + dS, V + dV
        return S, V


class CGequiVAE(nn.Module):
    """The sparse VAE; ``cfg`` a dict of the configuration's model keys."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["dec_type"] not in DECODERS:
            raise ValueError(f"this reference has the decoders {DECODERS}, not {cfg['dec_type']!r}")
        self.cfg = c = cfg
        f, act, n_rbf = c["n_basis"], c["activation"], c["n_rbf"]
        dtype = dtype_of(c["compute_dtype"])
        self.encoder = EquiEncoder(c["enc_nconv"], f, n_rbf, act, c["cg_cutoff"],
                                   c["contract_cutoff"], dtype)
        self.prior_net = CGprior(c["enc_nconv"], f, n_rbf, act, c["cg_cutoff"],
                                 max(100, c["n_cgs"]), dtype)
        if c["dec_type"] == "pseudo":
            self.dec = EquivariantPseudoDecoder(f, n_rbf, c["atom_cutoff"], c["dec_nconv"], act,
                                                c["breaksym"], dtype)
        else:
            self.dec = EquivariantDecoder(f, n_rbf, c["atom_cutoff"], c["dec_nconv"], act,
                                          c["dec_type"] == "cross", dtype)
        self.atom_munet = MLP(f, [f, f], activation="ReLU", dtype=dtype)
        self.atom_sigmanet = MLP(f, [f, f], activation="ReLU", dtype=dtype)

    def forward(self, g, generator: torch.Generator) -> VAEOutput:
        S_I = self.encoder(g)
        prior_mu, prior_sigma = self.prior_net(g)
        mu = self.atom_munet(S_I)
        sigma = 1e-12 + torch.exp(torch.clamp(self.atom_sigmanet(S_I), -30.0, 30.0) / 2.0)
        z = mu + sigma * draw_eps(mu, generator)
        _, cg_v = self.dec(g, z)
        xyz_rel = cg_v[g.mapping, :, g.channel_idx]
        offsets = segment_mean(xyz_rel, g.mapping, g.num_cg)
        xyz_recon = xyz_rel - offsets[g.mapping] + g.cg_xyz[g.mapping]
        return VAEOutput(mu=mu, sigma=sigma, prior_mu=prior_mu, prior_sigma=prior_sigma,
                         xyz=g.xyz, xyz_recon=xyz_recon)


Model = CGequiVAE
