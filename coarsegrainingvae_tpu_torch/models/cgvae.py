"""The sparse CGequiVAE, PCN and StochasticPCN, the flat graph, the H and
the rooted bond-length projections and the model switch (port of
``coarsegrainingvae_tpu.models.cgvae``).

A ``CGBatch`` is flattened into one graph (per-sample ids plus arithmetic
offsets, no host work) and every aggregation is a masked segment sum over a
receiver-sorted edge list (``ops/segment.py``, a CSR reduction with the
same bits on every call). The per-bead channel lift reads the precomputed
``channel_idx``. ``build_flagship_model`` picks this model or the dense
``DenseCGVAE`` exactly as the JAX package does.

The sparse path runs no hand-written kernel: the JAX package computes it
with ``jax.ops.segment_sum``, not with a Pallas kernel. Its noise comes
from an explicit generator, or ``eps=`` injected as in ``DenseCGVAE``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
from torch import nn

from coarsegrainingvae_tpu_torch.config import ModelConfig
from coarsegrainingvae_tpu_torch.data.batch import CGBatch, flatten_ids
from coarsegrainingvae_tpu_torch.models.conv import (
    ContractiveMessageBlock,
    ENMessageBlock,
    EquiMessageBlock,
    EquiMessageCross,
    EquiMessagePseudo,
    EquiMessagePseudo2,
    InvMessageBlock,
    UpdateBlock,
)
from coarsegrainingvae_tpu_torch.models.modules import MLP, Dense, EmbeddingZeroPad
from coarsegrainingvae_tpu_torch.ops.geometry import edge_vectors
from coarsegrainingvae_tpu_torch.ops.segment import segment_mean, segment_sum
from coarsegrainingvae_tpu_torch.parallel.mesh import RowNoise

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64}


@dataclass
class FlatGraph:
    """A CGBatch flattened to one global graph. The loss reads the first
    six fields; the sparse model also the bead arrays and the radius
    graphs, which a batch without graphs leaves None."""

    z: torch.Tensor          # (BN,)
    xyz: torch.Tensor        # (BN, 3)
    atom_mask: torch.Tensor  # (BN,)
    cg_mask: torch.Tensor    # (BM,)
    bonds: torch.Tensor      # (BEb, 2) global atom ids
    bond_mask: torch.Tensor  # (BEb,)
    cg_z: Optional[torch.Tensor] = None         # (BM,)
    cg_xyz: Optional[torch.Tensor] = None       # (BM, 3)
    mapping: Optional[torch.Tensor] = None      # (BN,) global bead ids
    channel_idx: Optional[torch.Tensor] = None  # (BN,)
    nbrs: Optional[torch.Tensor] = None         # (BE, 2) global, receiver-sorted
    nbr_mask: Optional[torch.Tensor] = None
    cg_nbrs: Optional[torch.Tensor] = None      # (BEc, 2) global, receiver-sorted
    cg_nbr_mask: Optional[torch.Tensor] = None
    num_nodes: int = 0
    num_cg: int = 0


def flatten_batch(batch: CGBatch) -> FlatGraph:
    b, n = batch.z.shape
    m = batch.cg_z.shape[1]

    def flat(t, stride=None):
        if t is None:
            return None
        return flatten_ids(t, stride) if stride is not None else t.reshape(-1)

    return FlatGraph(
        z=batch.z.reshape(-1),
        xyz=batch.xyz.reshape(-1, 3),
        atom_mask=batch.atom_mask.reshape(-1),
        cg_mask=batch.cg_mask.reshape(-1),
        bonds=flat(batch.bonds, n),
        bond_mask=flat(batch.bond_mask),
        cg_z=batch.cg_z.reshape(-1),
        cg_xyz=batch.cg_xyz.reshape(-1, 3),
        mapping=flatten_ids(batch.mapping, m),
        channel_idx=batch.channel_idx.reshape(-1),
        nbrs=flat(batch.nbrs, n),
        nbr_mask=flat(batch.nbr_mask),
        cg_nbrs=flat(batch.cg_nbrs, m),
        cg_nbr_mask=flat(batch.cg_nbr_mask),
        num_nodes=b * n,
        num_cg=b * m,
    )


@dataclass
class VAEOutput:
    """Flattened model outputs: per-bead (B*M, F) latent statistics and
    per-atom (B*N, 3) coordinates."""

    mu: Optional[torch.Tensor]
    sigma: Optional[torch.Tensor]
    prior_mu: Optional[torch.Tensor]
    prior_sigma: Optional[torch.Tensor]
    xyz: torch.Tensor
    xyz_recon: torch.Tensor


def project_h_bonds(xyz_recon: torch.Tensor, z: torch.Tensor, xyz_true: torch.Tensor,
                    bonds: torch.Tensor, bond_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Snap every hydrogen onto its covalent bond length along the decoded
    direction (models/cgvae.py:103-154 of the JAX package; differentiable
    almost everywhere). ``bonds`` is the graph-loss edge list, possibly
    directed and expanded to 1-3 pairs: each hydrogen keeps only its
    nearest heavy partner in the true geometry (a scatter-min over the
    hydrogens), and duplicate directed edges, which give the same target,
    are averaged with two index-adds. Those sums are order-independent:
    every selected edge of one hydrogen adds the same bits, the others add
    zero, so an atomic accumulator passes through the same values in any
    order. All arrays are flat (B*N, ...), bonds global ids."""
    a, b = bonds[:, 0], bonds[:, 1]
    za, zb = z[a], z[b]
    is_ha = (za == 1) & (zb != 1)
    is_hb = (zb == 1) & (za != 1)
    h_idx = torch.where(is_ha, a, b)
    p_idx = torch.where(is_ha, b, a)
    rest = torch.sqrt(torch.sum((xyz_true[h_idx] - xyz_true[p_idx]) ** 2, -1) + 1e-12)
    sel0 = is_ha | is_hb
    if bond_mask is not None:
        sel0 = sel0 & (bond_mask > 0)
    inf = torch.full_like(rest, float("inf"))
    min_rest = torch.full((xyz_recon.shape[0],), float("inf"), dtype=rest.dtype,
                          device=rest.device).scatter_reduce(
        0, h_idx, torch.where(sel0, rest, inf), "amin")
    sel = sel0 & (rest <= min_rest[h_idx] + 1e-6)
    d = xyz_recon[h_idx] - xyz_recon[p_idx]
    norm = torch.sqrt(torch.sum(d * d, -1) + 1e-12)
    target = xyz_recon[p_idx] + d * (rest / norm)[:, None]
    selw = sel.to(xyz_recon.dtype)
    acc = torch.zeros_like(xyz_recon).index_add(0, h_idx, target * selw[:, None])
    cnt = torch.zeros(xyz_recon.shape[0], dtype=xyz_recon.dtype,
                      device=xyz_recon.device).index_add(0, h_idx, selw)
    proj = acc / torch.clamp(cnt, min=1.0)[:, None]
    return torch.where((cnt > 0.0)[:, None], proj, xyz_recon)


def project_bonds_rooted(xyz_recon: torch.Tensor, xyz_true: torch.Tensor,
                         bonds: torch.Tensor, bond_mask: Optional[torch.Tensor],
                         root_mask: torch.Tensor, atom_mask: Optional[torch.Tensor] = None,
                         max_depth: int = 8, n_relax: int = 20) -> torch.Tensor:
    """Depth-ordered covalent bond-length projection rooted at pinned atoms
    (PCN's C-alphas; models/cgvae.py:157-215 of the JAX package). Every
    atom gets its breadth-first depth from the nearest root along the
    bonds (``max_depth`` rounds of scatter-min) and a parent one level up
    (scatter-max); then, depth by depth, each atom is put on its already
    placed parent at the true bond length along the decoded direction, so
    every tree bond is exact and the roots never move. The bonds that close
    rings get ``n_relax`` rounds of Jacobi relaxation: each movable atom
    moves by the degree-normalised sum of its bonds' length corrections.

    The scatters of int32 depths and parents give the same result in any
    order. The relaxation's per-atom float sums go through ``segment_sum``
    after a stable argsort of the bond endpoints (each atom's terms as the
    first endpoint in bond order, then as the second), so the card gives
    the same bits on every call. All arrays are flat (B*N, ...), bonds
    global ids."""
    n = xyz_recon.shape[0]
    a, b = bonds[:, 0], bonds[:, 1]
    bm = (torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
          if bond_mask is None else bond_mask > 0)
    if atom_mask is not None:
        bm = bm & (atom_mask[a] > 0) & (atom_mask[b] > 0)
    inf = torch.tensor(1_000_000, dtype=torch.int32, device=a.device)
    depth = torch.where(root_mask > 0, 0, inf).to(torch.int32)
    if atom_mask is not None:
        depth = torch.where(atom_mask > 0, depth, inf)
    for _ in range(max_depth):
        da, db = depth[a], depth[b]
        depth = depth.scatter_reduce(0, a, torch.where(bm, db + 1, inf), "amin")
        depth = depth.scatter_reduce(0, b, torch.where(bm, da + 1, inf), "amin")
    da, db = depth[a], depth[b]
    none = torch.full_like(a, -1)
    parent = torch.full((n,), -1, dtype=a.dtype, device=a.device)
    parent = parent.scatter_reduce(0, a, torch.where(bm & (da == db + 1), b, none), "amax")
    parent = parent.scatter_reduce(0, b, torch.where(bm & (db == da + 1), a, none), "amax")
    p = torch.clamp(parent, min=0)
    rest = torch.sqrt(torch.sum((xyz_true - xyz_true[p]) ** 2, -1) + 1e-12)
    x = xyz_recon
    for d in range(1, max_depth + 1):
        sel = (depth == d) & (parent >= 0)
        dvec = x - x[p]
        nrm = torch.sqrt(torch.sum(dvec * dvec, -1) + 1e-12)
        target = x[p] + dvec * (rest / nrm)[:, None]
        x = torch.where(sel[:, None], target, x)
    if n_relax > 0:
        bw = bm.to(x.dtype)
        rest_e = torch.sqrt(torch.sum((xyz_true[a] - xyz_true[b]) ** 2, -1) + 1e-12)
        ends = torch.cat([a, b])
        order = torch.argsort(ends, stable=True)
        ends = ends[order]
        deg = segment_sum(torch.cat([bw, bw])[order], ends, n, indices_are_sorted=True)
        movable = (root_mask <= 0) & (deg > 0)
        if atom_mask is not None:
            movable = movable & (atom_mask > 0)
        inv_deg = torch.where(deg > 0, 1.0 / torch.clamp(deg, min=1.0), 0.0)
        for _ in range(n_relax):
            dvec = x[a] - x[b]
            dist = torch.sqrt(torch.sum(dvec * dvec, -1) + 1e-12)
            corr = (bw * (dist - rest_e) / dist)[:, None] * dvec
            delta = segment_sum(torch.cat([-0.5 * corr, 0.5 * corr])[order], ends, n,
                                indices_are_sorted=True)
            x = x + torch.where(movable[:, None], delta * inv_deg[:, None], 0.0)
    return x


def project_batch_h_bonds(xyz_recon: torch.Tensor, batch: CGBatch) -> torch.Tensor:
    """``project_h_bonds`` of flat (B*N, 3) coordinates with the bond
    lengths of ``batch``'s atom coordinates."""
    g = flatten_batch(batch)
    return project_h_bonds(xyz_recon, g.z, g.xyz, g.bonds, g.bond_mask)


def draw_eps(like: torch.Tensor, generator, eps) -> torch.Tensor:
    """Standard normal noise shaped like ``like``: drawn from ``generator``
    on its device (a ``parallel.mesh.RowNoise`` draws this rank's rows of
    the global batch's noise), or ``eps`` given by the caller."""
    if eps is None and isinstance(generator, RowNoise):
        return generator.draw(like)
    if eps is None:
        return torch.randn(like.shape, generator=generator, device=like.device,
                           dtype=like.dtype)
    return eps.to(device=like.device, dtype=like.dtype).reshape(like.shape)


class EquiEncoder(nn.Module):
    """Atom-graph PaiNN encoder with a per-layer atom -> bead contraction
    (cgvae.py:194-331 of the original code). ``cutoff`` is the CG cutoff,
    which the original code wires into the atom graph's edge filters."""

    def __init__(self, n_conv, feat_dim, n_rbf, activation, cutoff, contract_cutoff=20.0,
                 degree_norm=False, dtype=torch.float32, generator=None):
        super().__init__()
        f, g = feat_dim, generator
        self.feat_dim = f
        self.embed = EmbeddingZeroPad(100, f, g)
        self.msgs = nn.ModuleList(
            EquiMessageBlock(f, activation, n_rbf, cutoff, degree_norm, dtype=dtype,
                             generator=g) for _ in range(n_conv))
        self.contract = nn.ModuleList(
            ContractiveMessageBlock(f, activation, n_rbf, contract_cutoff, dtype, g)
            for _ in range(n_conv))

    def forward(self, g: FlatGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.embed(g.z)
        v = torch.zeros((g.num_nodes, 3, self.feat_dim), dtype=h.dtype, device=h.device)
        r_ij = edge_vectors(g.xyz, g.nbrs)
        r_iI = g.xyz - g.cg_xyz[g.mapping]
        H = torch.zeros((g.num_cg, self.feat_dim), dtype=h.dtype, device=h.device)
        V = torch.zeros((g.num_cg, 3, self.feat_dim), dtype=h.dtype, device=h.device)
        for i, (msg, contract) in enumerate(zip(self.msgs, self.contract)):
            ds, dv = msg(h, v, r_ij, g.nbrs, g.nbr_mask)
            h = h + ds
            v = v + dv
            if i == 0:
                H = segment_mean(h, g.mapping, g.num_cg, g.atom_mask)
                V = segment_mean(v, g.mapping, g.num_cg, g.atom_mask)
            dH, dV = contract(h, v, r_iI, g.mapping, g.num_cg, g.atom_mask)
            H = H + dH
            V = V + dV
        return H, h


class CGprior(nn.Module):
    """Conditional prior p(z | CG geometry) (cgvae.py:334-403): PaiNN
    layers on the CG graph from a bead-index embedding of ``vocab`` rows,
    then the mu and sigma heads."""

    def __init__(self, n_conv, feat_dim, n_rbf, activation, cutoff, degree_norm=False,
                 vocab=100, dtype=torch.float32, generator=None):
        super().__init__()
        f, g = feat_dim, generator
        self.feat_dim = f
        self.embed = EmbeddingZeroPad(vocab, f, g)
        self.msgs = nn.ModuleList(
            EquiMessageBlock(f, activation, n_rbf, cutoff, degree_norm, dtype=dtype,
                             generator=g) for _ in range(n_conv))
        self.mu = MLP(f, [f, f], activation="Tanh", dtype=dtype, generator=g)
        self.logvar = MLP(f, [f, f], activation="Tanh", dtype=dtype, generator=g)

    def forward(self, g: FlatGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.embed(g.cg_z)
        v = torch.zeros((g.num_cg, 3, self.feat_dim), dtype=h.dtype, device=h.device)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for msg in self.msgs:
            ds, dv = msg(h, v, r_ij, g.cg_nbrs, g.cg_nbr_mask)
            h = h + ds
            v = v + dv
        logvar = torch.clamp(self.logvar(h), -30.0, 30.0)
        return self.mu(h), 1e-9 + torch.exp(logvar / 2.0)


class _CGDecoder(nn.Module):
    """A decoder over the CG graph: ``num_conv`` message blocks, each
    followed by an UpdateBlock when ``updates``."""

    def __init__(self, feat_dim, activation, msgs, updates: bool, dtype, generator):
        super().__init__()
        self.feat_dim = feat_dim
        self.msgs = nn.ModuleList(msgs)
        self.updates = nn.ModuleList(
            UpdateBlock(feat_dim, activation, dtype, generator) for _ in self.msgs
        ) if updates else None

    def _zeros(self, S):
        return torch.zeros((S.shape[0], 3, self.feat_dim), dtype=S.dtype, device=S.device)

    def _update(self, i, H, V):
        if self.updates is None:
            return H, V
        dH, dV = self.updates[i](H, V)
        return H + dH, V + dV


class EquivariantDecoder(_CGDecoder):
    """(EquiMessageCross | EquiMessageBlock) + UpdateBlock per layer
    (cgvae.py:129-191)."""

    def __init__(self, feat_dim, n_rbf, cutoff, num_conv, activation, cross=True,
                 degree_norm=False, dtype=torch.float32, generator=None):
        block = EquiMessageCross if cross else EquiMessageBlock
        super().__init__(feat_dim, activation, [
            block(feat_dim, activation, n_rbf, cutoff, degree_norm, dtype=dtype,
                  generator=generator) for _ in range(num_conv)], True, dtype, generator)

    def forward(self, g: FlatGraph, S: torch.Tensor):
        H, V = S, self._zeros(S)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for i, msg in enumerate(self.msgs):
            dH, dV = msg(H, V, r_ij, g.cg_nbrs, g.cg_nbr_mask)
            H, V = self._update(i, H + dH, V + dV)
        return H, V


class EquivariantPseudoDecoder(_CGDecoder):
    """Chirality-aware decoder (cgvae.py:52-125): EquiMessagePseudo (9-way)
    or EquiMessagePseudo2 (``variant="pseudo2"``) + UpdateBlock; breaksym
    seeds the pseudoscalar channel at 1."""

    def __init__(self, feat_dim, n_rbf, cutoff, num_conv, activation, breaksym=False,
                 variant="pseudo", dtype=torch.float32, generator=None):
        block = EquiMessagePseudo2 if variant == "pseudo2" else EquiMessagePseudo
        super().__init__(feat_dim, activation, [
            block(feat_dim, activation, n_rbf, cutoff, dtype=dtype, generator=generator)
            for _ in range(num_conv)], True, dtype, generator)
        self.breaksym = breaksym

    def forward(self, g: FlatGraph, S: torch.Tensor):
        V = self._zeros(S)
        Vbar = torch.zeros_like(V)
        Sbar = torch.ones_like(S) if self.breaksym else torch.zeros_like(S)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for i, msg in enumerate(self.msgs):
            dS, dSbar, dV, dVbar = msg(S, Sbar, V, Vbar, r_ij, g.cg_nbrs, g.cg_nbr_mask)
            Sbar, Vbar = Sbar + dSbar, Vbar + dVbar
            S, V = self._update(i, S + dS, V + dV)
        return S, V


class ENDecoder(_CGDecoder):
    """Plain EGNN decoder over the CG graph (cgvae.py:8-48), no updates."""

    def __init__(self, feat_dim, n_rbf, cutoff, num_conv, activation,
                 dtype=torch.float32, generator=None):
        super().__init__(feat_dim, activation, [
            ENMessageBlock(feat_dim, activation, n_rbf, cutoff, dtype=dtype,
                           generator=generator) for _ in range(num_conv)],
            False, dtype, generator)

    def forward(self, g: FlatGraph, S: torch.Tensor):
        H, V = S, self._zeros(S)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for msg in self.msgs:
            dH, dV = msg(H, V, r_ij, g.cg_nbrs, g.cg_nbr_mask)
            H, V = H + dH, V + dV
        return H, V


class InvariantDecoder(_CGDecoder):
    """Invariant-message decoder, the --invariantdec ablation
    (InvMessageBlock + UpdateBlock; conv.py:132-163)."""

    def __init__(self, feat_dim, n_rbf, cutoff, num_conv, activation,
                 dtype=torch.float32, generator=None):
        super().__init__(feat_dim, activation, [
            InvMessageBlock(feat_dim, activation, n_rbf, cutoff, dtype=dtype,
                            generator=generator) for _ in range(num_conv)],
            True, dtype, generator)

    def forward(self, g: FlatGraph, S: torch.Tensor):
        H, V = S, self._zeros(S)
        r_ij = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for i, msg in enumerate(self.msgs):
            dH, V = msg(H, V, r_ij, g.cg_nbrs, g.cg_nbr_mask)
            H, V = self._update(i, H + dH, V)
        return H, V


def lift_channels(cg_v: torch.Tensor, g: FlatGraph, offset: bool = True) -> torch.Tensor:
    """Per-bead vector channels (BM, 3, F) -> per-atom positions: atom i
    reads channel channel_idx[i] of its bead, then the centre-of-mass
    constraint and the bead anchor (cgvae.py:462-484)."""
    xyz_rel = cg_v[g.mapping, :, g.channel_idx]                  # (BN, 3)
    if offset:
        offsets = segment_mean(xyz_rel, g.mapping, g.num_cg, g.atom_mask)
        xyz_rel = xyz_rel - offsets[g.mapping]
    return xyz_rel + g.cg_xyz[g.mapping]


class CGequiVAE(nn.Module):
    """The sparse VAE (cgvae.py:406-513 of the original code): encode ->
    prior -> mu/sigma heads -> reparametrize -> decode -> channel lift.

    Parameters are drawn on the CPU from ``generator``; move the model with
    ``.to(device)``. ``forward`` and ``generate`` take the same arguments
    as ``DenseCGVAE``'s and return flat (B*M, F) statistics and (B*N, 3)
    coordinates.
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        f, g = c.n_basis, generator
        dtype = _DTYPES[c.compute_dtype]
        self.encoder = EquiEncoder(c.enc_nconv, f, c.n_rbf, c.activation, c.cg_cutoff,
                                   c.contract_cutoff, c.degree_norm, dtype, g)
        self.prior_net = CGprior(c.enc_nconv, f, c.n_rbf, c.activation, c.cg_cutoff,
                                 c.degree_norm, max(100, c.n_cgs), dtype, g)
        if c.dec_type in ("pseudo", "pseudo2"):
            self.dec = EquivariantPseudoDecoder(f, c.n_rbf, c.atom_cutoff, c.dec_nconv,
                                                c.activation, c.breaksym, c.dec_type, dtype, g)
        elif c.dec_type in ("cross", "painn"):
            self.dec = EquivariantDecoder(f, c.n_rbf, c.atom_cutoff, c.dec_nconv, c.activation,
                                          c.dec_type == "cross", c.degree_norm, dtype, g)
        elif c.dec_type == "en":
            self.dec = ENDecoder(f, c.n_rbf, c.atom_cutoff, c.dec_nconv, c.activation, dtype, g)
        elif c.dec_type == "inv":
            self.dec = InvariantDecoder(f, c.n_rbf, c.atom_cutoff, c.dec_nconv, c.activation,
                                        dtype, g)
        else:
            raise ValueError(f"unknown dec_type {c.dec_type!r}")
        # mu/sigma heads: Linear-ReLU-Linear (run_ala.py:184-185)
        self.atom_munet = MLP(f, [f, f], activation="ReLU", dtype=dtype, generator=g)
        self.atom_sigmanet = MLP(f, [f, f], activation="ReLU", dtype=dtype, generator=g)
        self.euclidean = None if c.equivariant else Dense(f, 3 * f, dtype=dtype, generator=g)

    def decode(self, g: FlatGraph, S_I: torch.Tensor) -> torch.Tensor:
        cg_s, cg_v = self.dec(g, S_I)
        if self.euclidean is not None:
            # non-equivariant "euclidean" head (cgvae.py:469-471)
            cg_v = self.euclidean(cg_s).reshape(cg_s.shape[0], self.cfg.n_basis, 3
                                                ).transpose(1, 2)
        xyz_recon = lift_channels(cg_v, g, offset=self.cfg.offset)
        if self.cfg.h_project:
            xyz_recon = project_h_bonds(xyz_recon, g.z, g.xyz, g.bonds, g.bond_mask)
        return xyz_recon

    def forward(self, batch: CGBatch, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        g = flatten_batch(batch)
        S_I, _ = self.encoder(g)
        prior_mu, prior_sigma = self.prior_net(g)
        mu = self.atom_munet(S_I)
        logvar = torch.clamp(self.atom_sigmanet(S_I), -30.0, 30.0)
        sigma = 1e-12 + torch.exp(logvar / 2.0)
        z = S_I if self.cfg.det else mu + sigma * draw_eps(mu, generator, eps)
        return VAEOutput(mu=mu, sigma=sigma, prior_mu=prior_mu, prior_sigma=prior_sigma,
                         xyz=g.xyz, xyz_recon=self.decode(g, z))

    def generate(self, batch: CGBatch, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B*N, 3) coordinates drawn from the CG prior and decoded; atom
        coordinates in ``batch`` are read only by ``h_project``."""
        g = flatten_batch(batch)
        prior_mu, prior_sigma = self.prior_net(g)
        return self.decode(g, prior_mu + prior_sigma * draw_eps(prior_mu, generator, eps))


def _as_graph(batch: Union[CGBatch, FlatGraph]) -> FlatGraph:
    return batch if isinstance(batch, FlatGraph) else flatten_batch(batch)


class PCN(nn.Module):
    """Protein Completion Network (cgvae.py:516-594 of the original code):
    residue-type embedding -> equivariant decoder over the C-alpha graph ->
    channel lift, with each residue's C-alpha pinned to its bead when
    ``ca_recenter``. The original code fixes the cross decoder; ``dec_type``
    pseudo or pseudo2 picks the chirality-aware decoder, as in the JAX
    package. Parameters are drawn on the CPU from ``generator``."""

    def __init__(self, cfg: ModelConfig, ca_recenter: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = c = cfg
        self.ca_recenter = ca_recenter
        f, g = c.n_basis, generator
        dtype = _DTYPES[c.compute_dtype]
        self.embedding = EmbeddingZeroPad(100, f, g)
        if c.dec_type in ("pseudo", "pseudo2"):
            self.dec = EquivariantPseudoDecoder(f, c.n_rbf, c.atom_cutoff, c.dec_nconv,
                                                c.activation, c.breaksym, c.dec_type, dtype, g)
        else:
            self.dec = EquivariantDecoder(f, c.n_rbf, c.atom_cutoff, c.dec_nconv, c.activation,
                                          c.dec_type != "painn", dtype=dtype, generator=g)

    def _decode(self, g: FlatGraph, S_I: torch.Tensor,
                ca_mask: Optional[torch.Tensor]) -> torch.Tensor:
        _, cg_v = self.dec(g, S_I)
        xyz_rel = cg_v[g.mapping, :, g.channel_idx]                   # (BN, 3)
        if self.ca_recenter and ca_mask is not None:
            # zero each residue's C-alpha displacement, at the C-alpha only
            cam = ca_mask.reshape(-1).to(xyz_rel.dtype)[:, None]
            xyz_rel = xyz_rel - xyz_rel * cam
        return xyz_rel + g.cg_xyz[g.mapping]

    def forward(self, batch: Union[CGBatch, FlatGraph],
                ca_mask: Optional[torch.Tensor] = None) -> VAEOutput:
        """ca_mask (B, N) marks each residue's C-alpha atom. Every entry
        point takes the padded batch or its ``flatten_batch`` graph, so a
        caller that needs the graph too builds it once."""
        g = _as_graph(batch)
        return VAEOutput(mu=None, sigma=None, prior_mu=None, prior_sigma=None, xyz=g.xyz,
                         xyz_recon=self._decode(g, self.embedding(g.cg_z), ca_mask))


class StochasticPCN(PCN):
    """The CVAE variant of PCN (``run_pcn --stochastic``; the JAX package's
    extension, cgvae.py:613-743 there): a per-residue invariant latent from
    an encoder that sees the true all-atom geometry (atoms pooled into
    their residue by a ContractiveMessageBlock, then PaiNN layers over the
    C-alpha graph), a C-alpha-conditioned prior, and the PCN decoder
    conditioned on the residue embedding plus Dense(z). ``forward`` and
    ``generate`` draw their noise from ``generator`` or take ``eps``, as
    ``CGequiVAE`` does."""

    def __init__(self, cfg: ModelConfig, ca_recenter: bool = True,
                 generator: Optional[torch.Generator] = None):
        super().__init__(cfg, ca_recenter, generator)
        c, f, g = cfg, cfg.n_basis, generator
        dtype = _DTYPES[c.compute_dtype]
        n_enc = max(c.enc_nconv, 1)
        self.atom_embedding = EmbeddingZeroPad(100, f, g)
        self.enc_contract = ContractiveMessageBlock(f, c.activation, c.n_rbf,
                                                    c.contract_cutoff, dtype, g)
        self.enc_msgs = nn.ModuleList(
            EquiMessageBlock(f, c.activation, c.n_rbf, c.atom_cutoff, dtype=dtype, generator=g)
            for _ in range(n_enc))
        self.enc_upds = nn.ModuleList(UpdateBlock(f, c.activation, dtype, g)
                                      for _ in range(n_enc + 1))
        self.munet = MLP(f, [f, f], activation="ReLU", dtype=dtype, generator=g)
        self.sigmanet = MLP(f, [f, f], activation="ReLU", dtype=dtype, generator=g)
        self.latent_mix = Dense(f, f, dtype=dtype, generator=g)
        self.prior_net = CGprior(n_enc, f, c.n_rbf, c.activation, c.atom_cutoff, dtype=dtype,
                                 generator=g)

    def encode(self, g: FlatGraph) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.atom_embedding(g.z)
        v = torch.zeros((g.num_nodes, 3, h.shape[-1]), dtype=h.dtype, device=h.device)
        r_iI = g.xyz - g.cg_xyz[g.mapping]
        # atoms -> their residue; the offsets r_iI carry the rotamer
        H = segment_mean(h, g.mapping, g.num_cg, g.atom_mask)
        dH, V = self.enc_contract(h, v, r_iI, g.mapping, g.num_cg, g.atom_mask)
        H = H + dH
        # the update's inner products tell apart rotamers whose atom
        # distance sets coincide
        dH, dV = self.enc_upds[0](H, V)
        H, V = H + dH, V + dV
        r_IJ = edge_vectors(g.cg_xyz, g.cg_nbrs)
        for msg, upd in zip(self.enc_msgs, self.enc_upds[1:]):
            dH, dV = msg(H, V, r_IJ, g.cg_nbrs, g.cg_nbr_mask)
            H, V = H + dH, V + dV
            dH, dV = upd(H, V)
            H, V = H + dH, V + dV
        mu = self.munet(H)
        logvar = torch.clamp(self.sigmanet(H), -30.0, 30.0)
        return mu, 1e-12 + torch.exp(logvar / 2.0)

    def _condition(self, g: FlatGraph, z: torch.Tensor) -> torch.Tensor:
        return self.embedding(g.cg_z) + self.latent_mix(z)

    def forward(self, batch: Union[CGBatch, FlatGraph], ca_mask: Optional[torch.Tensor] = None,
                eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        g = _as_graph(batch)
        mu, sigma = self.encode(g)
        prior_mu, prior_sigma = self.prior_net(g)
        z = mu + sigma * draw_eps(mu, generator, eps)
        return VAEOutput(mu=mu, sigma=sigma, prior_mu=prior_mu, prior_sigma=prior_sigma,
                         xyz=g.xyz, xyz_recon=self._decode(g, self._condition(g, z), ca_mask))

    def reconstruct_mean(self, batch: Union[CGBatch, FlatGraph],
                         ca_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The posterior-mean reconstruction (z = mu), (B*N, 3)."""
        g = _as_graph(batch)
        mu, _ = self.encode(g)
        return self._decode(g, self._condition(g, mu), ca_mask)

    def generate(self, batch: Union[CGBatch, FlatGraph], ca_mask: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B*N, 3) coordinates from the C-alpha trace alone: z drawn from
        the prior, then decoded."""
        g = _as_graph(batch)
        prior_mu, prior_sigma = self.prior_net(g)
        z = prior_mu + prior_sigma * draw_eps(prior_mu, generator, eps)
        return self._decode(g, self._condition(g, z), ca_mask)


def build_flagship_model(cfg: ModelConfig, force_sparse: bool = False,
                         generator: Optional[torch.Generator] = None):
    """The one place that picks the model class for a config, used by the
    training CLI and by checkpoint reloading (``cli/postanalysis.py``,
    ``Backmapper.from_run``), which must rebuild the parameters the run
    trained: the sparse ``CGequiVAE`` for ``force_sparse``, ``cfg.sparse``
    and the pseudo2/en/inv decoders, which exist only in it; else the dense
    ``DenseCGVAE``. Parameters are drawn on the CPU from ``generator``."""
    if force_sparse or cfg.sparse or cfg.dec_type in ("pseudo2", "en", "inv"):
        return CGequiVAE(cfg, generator=generator)
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE

    return DenseCGVAE(cfg, generator=generator)
