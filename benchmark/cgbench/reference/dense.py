"""Plain reference of the dense CGVAE (the port's ``DenseCGVAE``).

A frozen copy of the port's plain code at commit add70c80:
``ops/geometry.py::pair_filter_basis``, ``ops/fused_message.py::
message_reference``, ``ops/fused_pseudo.py::pseudo_reference`` and
``models/dense_cgvae.py`` / ``models/dense.py`` with every message block on
those plain einsums (the port runs the fused CUDA kernels there), no
tensor-parallel split, and gradients by autograd of the plain forward. The
decoder is the pseudo one, the cross one or the PaiNN one, as ``dec_type``
says. Submodule and parameter names are the port's, so one set of weights
loads into both by name. Imports nothing of the port.

The family's interface to the harness: ``Model`` (built from the
configuration's dict), ``inputs`` (what it takes of a batch) and ``KEYS``
(the configuration keys it reads).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from cgbench.reference.layers import (
    EPS_DENSE,
    MLP,
    Dense,
    DistanceEmbed,
    EmbeddingZeroPad,
    UpdateBlock,
    cosine_envelope,
    dtype_of,
    factored_filter,
    painn_radial_basis,
)


@dataclass
class VAEOutput:
    mu: torch.Tensor            # (B*M, F)
    sigma: torch.Tensor
    prior_mu: torch.Tensor
    prior_sigma: torch.Tensor
    xyz: torch.Tensor           # (B*N, 3)
    xyz_recon: torch.Tensor


def draw_eps(like: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Standard normals shaped like ``like``, in its dtype, from ``generator``."""
    return torch.randn(like.shape, generator=generator, device=like.device, dtype=like.dtype)


def pair_filter_basis(xyz: torch.Tensor, mask: torch.Tensor, cutoff: float, n_rbf: int):
    """(unit, adj, k): k = adj * env * [rbf_1..R, 1], (B, N, N, R+1)."""
    r_ij = xyz[:, None, :, :] - xyz[:, :, None, :]
    dist = torch.sqrt(torch.sum(r_ij**2, dim=-1) + EPS_DENSE)
    unit = r_ij / dist[..., None]
    n = dist.shape[-1]
    adj = (dist < cutoff).to(dist.dtype)
    adj = adj * (1.0 - torch.eye(n, dtype=dist.dtype, device=dist.device))
    m = mask.to(dist.dtype)
    adj = adj * m[:, :, None] * m[:, None, :]
    rbf = painn_radial_basis(dist, n_rbf, cutoff)
    rbf = torch.cat([rbf, torch.ones_like(rbf[..., :1])], dim=-1)
    k = (adj * cosine_envelope(dist, cutoff))[..., None] * rbf
    return unit, adj, k


KEYS = ("n_cgs", "n_basis", "n_rbf", "atom_cutoff", "cg_cutoff", "enc_nconv", "dec_nconv",
        "activation", "contract_cutoff", "dec_type", "breaksym", "compute_dtype")
DECODERS = ("pseudo", "cross", "painn")


def message(xyz, mask, phi, v, w, cutoff: float, n_rbf: int):
    """The factored PaiNN message (kernels 1-2's function): (ds, dv), the
    sums in ``phi``'s dtype, the geometry in ``xyz``'s."""
    cross = phi.shape[2] == 4
    unit, _, k = (t.to(phi.dtype) for t in
                  pair_filter_basis(xyz, mask.to(xyz.dtype), cutoff, n_rbf))
    g_b = torch.einsum("bijr,bjf->birf", k, phi[:, :, 1])
    ds = torch.einsum("birf,rf->bif", g_b, w[:, 1])
    ku = torch.einsum("bijr,bijd->bijrd", k, unit)
    g_c = torch.einsum("bijrd,bjf->birdf", ku, phi[:, :, 2])
    dv = torch.einsum("birdf,rf->bidf", g_c, w[:, 2])
    p_a = phi[:, :, 0][:, :, None, :] * v
    g_a = torch.einsum("bijr,bjdf->birdf", k, p_a)
    dv = dv + torch.einsum("birdf,rf->bidf", g_a, w[:, 0])
    if cross:
        p_3 = phi[:, :, 3][:, :, None, :] * v
        g_3 = torch.einsum("bijr,bjdf->birdf", k, p_3)
        w3 = torch.einsum("birdf,rf->bidf", g_3, w[:, 3])
        dv = dv + torch.cross(v, w3, dim=-2)
    return ds, dv


def pseudo_message(xyz, mask, phi, s, sbar, v, vbar, w, cutoff: float, n_rbf: int):
    """The 9-channel chirality message (kernels 3-4's function), the sums in
    ``phi``'s dtype."""
    unit, adj, k = (t.to(phi.dtype) for t in
                    pair_filter_basis(xyz, mask.to(xyz.dtype), cutoff, n_rbf))
    filt = torch.einsum("bijr,rcf->bijcf", k, w)
    g = filt * phi[:, None, :, :, :]
    ds = s * torch.sum(g[..., 0, :], dim=2)
    dsbar = torch.sum(v * torch.sum(adj[..., None, None] * vbar[:, None], dim=2), dim=2)
    u1 = torch.sum(g[..., 1, None, :] * unit[..., :, None], dim=2)

    def agg(ch, x):
        return torch.einsum("bijf,bjdf->bidf", g[..., ch, :], x)

    gate = sbar[:, :, None, :]
    dv = u1 + agg(2, v) + torch.cross(v, agg(3, vbar), dim=-2) + gate * agg(4, vbar)
    dvbar = (agg(5, vbar) + gate * agg(6, v) + torch.cross(v, agg(7, v), dim=-2)
             + torch.cross(vbar, agg(8, vbar), dim=-2))
    return ds, dsbar, dv, dvbar


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float().contiguous()


def _as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return t.to(dtype).contiguous()


class DenseFactoredEquiMessage(nn.Module):
    def __init__(self, feat_dim: int, activation: str, n_rbf: int, cutoff: float,
                 cross: bool = False, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feat_dim
        self.n_split = 4 if cross else 3
        self.feat_dim, self.n_rbf, self.cutoff = f, n_rbf, cutoff
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype)
        self.phi_out = Dense(f, self.n_split * f, dtype=dtype)
        self.filter_w = factored_filter(n_rbf, self.n_split, f, dtype)
        self.message_dtype = torch.float32

    def forward(self, s, v, xyz, node_mask):
        b, n, f = s.shape
        dt = self.message_dtype
        phi = self.phi_out(self.phi_in(s)).reshape(b, n, self.n_split, f)
        out = message(_f32(xyz), _f32(node_mask), _as(phi, dt), _as(v, dt),
                      _as(self.filter_w, dt), self.cutoff, self.n_rbf)
        return tuple(t.float() for t in out)


class DenseEquiMessagePseudo(nn.Module):
    def __init__(self, feat_dim: int, activation: str, n_rbf: int, cutoff: float,
                 dtype: torch.dtype = torch.float32, filter_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feat_dim
        self.feat_dim, self.n_rbf, self.cutoff = f, n_rbf, cutoff
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype)
        self.phi_out = Dense(f, 9 * f, dtype=dtype)
        self.filter_w = factored_filter(n_rbf, 9, f, filter_dtype)
        self.message_dtype = torch.float32

    def forward(self, s, sbar, v, vbar, xyz, node_mask):
        b, m, f = s.shape
        dt = self.message_dtype
        phi = self.phi_out(self.phi_in(s)).reshape(b, m, 9, f)
        out = pseudo_message(_f32(xyz), _f32(node_mask), _as(phi, dt), _as(s, dt), _as(sbar, dt),
                             _as(v, dt), _as(vbar, dt), _as(self.filter_w, dt), self.cutoff,
                             self.n_rbf)
        return tuple(t.float() for t in out)


class DenseContractive(nn.Module):
    def __init__(self, feat_dim: int, activation: str, n_rbf: int, cutoff: float,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feat_dim
        self.feat_dim = f
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype)
        self.phi_out = Dense(f, 3 * f, dtype=dtype)
        self.embed = DistanceEmbed(n_rbf, cutoff, 3 * f, dtype)

    def forward(self, s, v, r_iI, onehot):
        f = self.feat_dim
        d = torch.sqrt(torch.sum(r_iI**2 + 1e-8, dim=-1))
        unit = r_iI / d[..., None]
        phi = self.phi_out(self.phi_in(s))
        inv = (phi * self.embed(d)).reshape(s.shape[:2] + (3, f))
        a, b, c = inv[..., 0, :], inv[..., 1, :], inv[..., 2, :]
        dv = c[:, :, None, :] * unit[..., None] + a[:, :, None, :] * v
        dV = torch.einsum("bnk,bndf->bkdf", onehot, dv)
        dS = torch.einsum("bnk,bnf->bkf", onehot, b)
        return dS, dV


class DenseUpdateBlock(nn.Module):
    def __init__(self, feat_dim: int, activation: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.update = UpdateBlock(feat_dim, activation, dtype)

    def forward(self, s, v):
        b, n, f = s.shape
        ds, dv = self.update(s.reshape(b * n, f), v.reshape(b * n, 3, f))
        return ds.reshape(b, n, f), dv.reshape(b, n, 3, f)


class DenseCGVAE(nn.Module):
    """The dense CGVAE, as the port's ``DenseCGVAE``. ``cfg`` is a dict of
    the configuration's model keys."""

    def __init__(self, cfg: dict):
        super().__init__()
        if cfg["dec_type"] not in DECODERS:
            raise ValueError(f"this reference has the decoders {DECODERS}, not {cfg['dec_type']!r}")
        self.cfg = c = cfg
        f = c["n_basis"]
        dtype = dtype_of(c["compute_dtype"])
        act, n_rbf = c["activation"], c["n_rbf"]

        def msg(cutoff):
            return DenseFactoredEquiMessage(f, act, n_rbf, cutoff, False, dtype)

        self.atom_embed = EmbeddingZeroPad(100, f)
        self.enc_msgs = nn.ModuleList(msg(c["cg_cutoff"]) for _ in range(c["enc_nconv"]))
        self.enc_contract = nn.ModuleList(
            DenseContractive(f, act, n_rbf, c["contract_cutoff"], dtype)
            for _ in range(c["enc_nconv"]))
        self.bead_embed = EmbeddingZeroPad(max(100, c["n_cgs"]), f)
        self.prior_msgs = nn.ModuleList(msg(c["cg_cutoff"]) for _ in range(c["enc_nconv"]))
        self.prior_mu = MLP(f, [f, f], activation="Tanh", dtype=dtype)
        self.prior_logvar = MLP(f, [f, f], activation="Tanh", dtype=dtype)
        self.post_mu = MLP(f, [f, f], activation="ReLU", dtype=dtype)
        self.post_logvar = MLP(f, [f, f], activation="ReLU", dtype=dtype)
        if c["dec_type"] == "pseudo":
            self.dec_msgs = nn.ModuleList(
                DenseEquiMessagePseudo(f, act, n_rbf, c["atom_cutoff"], dtype, torch.float32)
                for _ in range(c["dec_nconv"]))
        else:
            self.dec_msgs = nn.ModuleList(
                DenseFactoredEquiMessage(f, act, n_rbf, c["atom_cutoff"],
                                         c["dec_type"] == "cross", dtype)
                for _ in range(c["dec_nconv"]))
        self.dec_updates = nn.ModuleList(
            DenseUpdateBlock(f, act, dtype) for _ in range(c["dec_nconv"]))

    def forward(self, batch, generator: torch.Generator) -> VAEOutput:
        c, f = self.cfg, self.cfg["n_basis"]
        b, n = batch.z.shape
        m = batch.cg_z.shape[1]
        onehot = F.one_hot(batch.mapping, m).to(torch.float32)
        onehot = onehot * batch.atom_mask[..., None].to(torch.float32)
        norm = onehot / torch.clamp(onehot.sum(dim=1, keepdim=True), min=1e-8)
        # encoder
        xyz = batch.xyz
        r_iI = xyz - torch.einsum("bkd,bnk->bnd", batch.cg_xyz, onehot)
        h = self.atom_embed(batch.z)
        v = torch.zeros((b, n, 3, f), dtype=h.dtype, device=h.device)
        H = torch.zeros((b, m, f), dtype=h.dtype, device=h.device)
        V = torch.zeros((b, m, 3, f), dtype=h.dtype, device=h.device)
        for i in range(c["enc_nconv"]):
            ds, dv = self.enc_msgs[i](h, v, xyz, batch.atom_mask)
            h, v = h + ds, v + dv
            if i == 0:
                H = torch.einsum("bnk,bnf->bkf", norm, h)
                V = torch.einsum("bnk,bndf->bkdf", norm, v)
            dH, dV = self.enc_contract[i](h, v, r_iI, onehot)
            H, V = H + dH, V + dV
        mu = self.post_mu(H)
        sigma = 1e-12 + torch.exp(torch.clamp(self.post_logvar(H), -30.0, 30.0) / 2.0)
        # prior
        Hp = self.bead_embed(batch.cg_z)
        Vp = torch.zeros((b, m, 3, f), dtype=Hp.dtype, device=Hp.device)
        for layer in self.prior_msgs:
            dH, dV = layer(Hp, Vp, batch.cg_xyz, batch.cg_mask)
            Hp, Vp = Hp + dH, Vp + dV
        prior_mu = self.prior_mu(Hp)
        prior_sigma = 1e-9 + torch.exp(torch.clamp(self.prior_logvar(Hp), -30.0, 30.0) / 2.0)
        # reparametrise and decode
        S = mu + sigma * draw_eps(mu, generator)
        Vd = torch.zeros((b, m, 3, f), dtype=S.dtype, device=S.device)
        Sbar = torch.ones_like(S) if c["breaksym"] else torch.zeros_like(S)
        Vbar = torch.zeros_like(Vd)
        for msg, upd in zip(self.dec_msgs, self.dec_updates):
            if c["dec_type"] == "pseudo":
                dS, dSb, dV, dVb = msg(S, Sbar, Vd, Vbar, batch.cg_xyz, batch.cg_mask)
                Sbar, Vbar = Sbar + dSb, Vbar + dVb
            else:
                dS, dV = msg(S, Vd, batch.cg_xyz, batch.cg_mask)
            S, Vd = S + dS, Vd + dV
            dS, dV = upd(S, Vd)
            S, Vd = S + dS, Vd + dV
        bi = torch.arange(b, device=Vd.device)[:, None]
        xyz_rel = Vd[bi, batch.mapping, :, batch.channel_idx]
        offsets = torch.einsum("bnk,bnd->bkd", norm, xyz_rel)
        xyz_rel = xyz_rel - torch.einsum("bkd,bnk->bnd", offsets, onehot)
        anchor = torch.einsum("bkd,bnk->bnd", batch.cg_xyz, onehot)
        xyz_recon = (xyz_rel + anchor).reshape(-1, 3)
        return VAEOutput(mu=mu.reshape(b * m, f), sigma=sigma.reshape(b * m, f),
                         prior_mu=prior_mu.reshape(b * m, f),
                         prior_sigma=prior_sigma.reshape(b * m, f),
                         xyz=batch.xyz.reshape(b * n, 3), xyz_recon=xyz_recon)


Model = DenseCGVAE


def inputs(batch, cfg: dict):
    """The dense model reads the padded batch itself."""
    return batch
