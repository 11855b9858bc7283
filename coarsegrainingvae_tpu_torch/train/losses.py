"""Loss stack: reconstruction + beta*KL + gamma*graph (port of
``coarsegrainingvae_tpu.train.losses``; utils.py:89-191 of the original
code), with the repo's extensions: the excluded-volume (steric) term
(``build_steric_tables``, ``steric_loss``, ``zeta``), ``h_bond_weight`` and
``eta_h``; ``steric_loss_batched`` is the steric term of PCN's
multi-topology batches.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.eval.metrics import COVALENT_RADII
from coarsegrainingvae_tpu_torch.models.cgvae import FlatGraph, VAEOutput

EPS = 1e-6  # utils.py:15 of the original code


def kl_divergence(
    mu1: torch.Tensor,
    std1: torch.Tensor,
    mu2: Optional[torch.Tensor] = None,
    std2: Optional[torch.Tensor] = None,
    legacy: bool = False,
    mask: Optional[torch.Tensor] = None,
    denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Diagonal-Gaussian KL (utils.py:81-86 of the original code), against
    N(0, 1) when mu2 is None, else against (mu2, std2). legacy=True divides
    the mean term by std2 instead of std2**2, as the original code does.
    ``denom`` replaces the mean's count (``loss_denominators``)."""
    if mu2 is None:
        per_node = -0.5 * torch.sum(
            1 + torch.log(std1**2) - mu1**2 - std1**2, dim=-1
        )
    else:
        var2 = std2 if legacy else std2**2
        per_node = 0.5 * (
            torch.sum(std1**2 / std2**2, -1)
            + torch.sum((mu1 - mu2) ** 2 / var2, -1)
            + torch.sum(torch.log(std2**2), -1)
            - torch.sum(torch.log(std1**2), -1)
            - mu1.shape[-1]
        )
    if mask is not None:
        m = mask.to(per_node.dtype)
        if denom is None:
            denom = torch.clamp(torch.sum(m), min=1.0)
        return torch.sum(per_node * m) / denom.to(per_node.dtype)
    return torch.mean(per_node) if denom is None else \
        torch.sum(per_node) / denom.to(per_node.dtype)


def recon_loss(xyz: torch.Tensor, xyz_recon: torch.Tensor,
               mask: Optional[torch.Tensor] = None,
               denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coordinate MSE, mean over atoms and xyz (utils.py:124); ``denom``
    replaces the mean's count."""
    sq = (xyz_recon - xyz) ** 2
    if mask is not None:
        m = mask.to(sq.dtype)[:, None]
        if denom is None:
            denom = torch.clamp(torch.sum(m) * 3.0, min=1.0)
        return torch.sum(sq * m) / denom.to(sq.dtype)
    return torch.mean(sq) if denom is None else torch.sum(sq) / denom.to(sq.dtype)


def graph_loss(
    xyz: torch.Tensor, xyz_recon: torch.Tensor, bonds: torch.Tensor,
    bond_mask: Optional[torch.Tensor] = None,
    edge_weight: Optional[torch.Tensor] = None,
    denom: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MSE of bonded-edge distances between data and reconstruction
    (utils.py:127-133); ``edge_weight`` rescales edges in the weighted
    mean; ``denom`` replaces the mean's count."""
    gen_d = torch.sqrt(
        torch.sum((xyz_recon[bonds[:, 0]] - xyz_recon[bonds[:, 1]]) ** 2, -1) + EPS
    )
    dat_d = torch.sqrt(
        torch.sum((xyz[bonds[:, 0]] - xyz[bonds[:, 1]]) ** 2, -1) + EPS
    )
    sq = (gen_d - dat_d) ** 2
    if bond_mask is not None:
        m = bond_mask.to(sq.dtype)
        if edge_weight is not None:
            m = m * edge_weight
        if denom is None:
            denom = torch.clamp(torch.sum(m), min=1.0)
        return torch.sum(sq * m) / denom.to(sq.dtype)
    if edge_weight is not None:
        if denom is None:
            denom = torch.clamp(torch.sum(edge_weight), min=1.0)
        return torch.sum(sq * edge_weight) / denom.to(sq.dtype)
    return torch.mean(sq) if denom is None else torch.sum(sq) / denom.to(sq.dtype)


def build_steric_tables(z, bonds, scale: float = 1.3, margin: float = 0.3,
                        frames=None) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side (numpy) excluded-volume tables for ``steric_loss``.

    z (N,) atomic numbers (0 = padding); bonds (Eb, 2) covalent bonds only.
    Returns (thresh (N, N) float32, pair_mask (N, N) bool): for every
    nonbonded pair of real atoms, the distance below which the bond-graph
    validity metric would see a spurious edge, scale * (r_i + r_j), plus
    ``margin``. With ``frames`` (T, N, 3) each pair's threshold is instead
    the ensemble's own closest approach, clipped into [that cutoff, cutoff
    + margin] (``--steric_data_margin``); the (T, N, N) minimum is taken in
    chunks that bound host memory."""
    z = np.asarray(z)
    n = z.shape[0]
    real = z > 0
    r = np.array([COVALENT_RADII.get(int(v), 1.5) for v in z])
    base = (r[None, :] + r[:, None]) * scale
    thresh = base + margin
    if frames is not None:
        frames = np.asarray(frames, np.float32)
        dmin = np.full((n, n), np.inf, np.float32)
        chunk = max(1, min(512, int(1.5e8 // (n * n))))
        for lo in range(0, frames.shape[0], chunk):
            c = frames[lo:lo + chunk]
            d = np.sqrt(((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)).min(0)
            np.minimum(dmin, d, out=dmin)
        thresh = np.clip(dmin, base, base + margin)
    mask = real[None, :] & real[:, None]
    mask[np.arange(n), np.arange(n)] = False
    for a, b in np.asarray(bonds).reshape(-1, 2):
        mask[int(a), int(b)] = mask[int(b), int(a)] = False
    return thresh.astype(np.float32), mask


def steric_loss(xyz_recon: torch.Tensor, thresh: torch.Tensor,
                pair_mask: torch.Tensor, denom: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared hinge on nonbonded pair distances below ``thresh``.
    xyz_recon (B*N, 3) flat; thresh, pair_mask (N, N), one topology for the
    batch. A dense (B, N, N) pass; ``denom`` replaces the mean's count."""
    n = thresh.shape[0]
    xyz = xyz_recon.reshape(-1, n, 3)
    d = torch.sqrt(torch.sum((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2, -1) + EPS)
    viol = torch.clamp(thresh[None] - d, min=0.0)
    m = pair_mask.to(viol.dtype)[None]
    if denom is None:
        denom = torch.clamp(pair_mask.sum().to(viol.dtype) * xyz.shape[0], min=1.0)
    return torch.sum(viol**2 * m) / denom.to(viol.dtype)


def steric_loss_batched(xyz_recon: torch.Tensor, z: torch.Tensor, bonds: torch.Tensor,
                        bond_mask: torch.Tensor, scale: float = 1.3,
                        margin: float = 0.3) -> torch.Tensor:
    """The excluded-volume hinge for multi-topology padded batches (PCN,
    ``data/sidechain.py``; losses.py:165-208 of the JAX package): every
    sample has its own atoms and bonds, so the (N, N) tables are built in
    the step from the batch. xyz_recon (B*N, 3) flat; z (B, N) atomic
    numbers, 0 = padding; bonds (B, Eb, 2) local pairs with bond_mask
    (B, Eb). The squared hinge on nonbonded real-atom pair distances below
    scale * (r_i + r_j) + margin, averaged over those pairs; a dense
    (B, N, N) pass. The bonded pairs leave the mask by index assignment,
    which gives the same mask in any order."""
    b, n = z.shape
    xyz = xyz_recon.reshape(b, n, 3)
    radii = torch.tensor([1.5] + [COVALENT_RADII.get(k, 1.5) for k in range(1, 120)],
                         dtype=xyz.dtype, device=xyz.device)
    r = radii[torch.clamp(z, 0, 119)]
    thresh = (r[:, :, None] + r[:, None, :]) * scale + margin
    real = z > 0
    mask = real[:, :, None] & real[:, None, :]
    mask = mask & ~torch.eye(n, dtype=torch.bool, device=z.device)[None]
    # padded bond rows go to (0, 0), the diagonal, which is already out
    i = torch.where(bond_mask, bonds[..., 0], 0)
    j = torch.where(bond_mask, bonds[..., 1], 0)
    bi = torch.arange(b, device=z.device)[:, None].expand_as(i)
    mask[bi, i, j] = False
    mask[bi, j, i] = False
    d = torch.sqrt(torch.sum((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2, -1) + EPS)
    m = mask.to(d.dtype)
    viol = torch.clamp(thresh - d, min=0.0) * m
    return torch.sum(viol**2) / torch.clamp(torch.sum(m), min=1.0)


def _touches_h(g: FlatGraph) -> torch.Tensor:
    return (g.z[g.bonds[:, 0]] == 1) | (g.z[g.bonds[:, 1]] == 1)


def loss_denominators(g: FlatGraph, n_frames: int, gamma: float,
                      steric: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
                      h_bond_weight: float = 1.0, eta_h: float = 0.0,
                      shards: int = 1) -> Dict[str, torch.Tensor]:
    """Each ``vae_loss`` term's count over the global batch ``g`` of
    ``n_frames`` frames (the masks' sums, as the terms take them), divided
    by ``shards``. Under data parallelism a rank sums its own rows over
    these denominators; the mean of the ranks' terms is then the global
    batch's mean, masks and all, however the counts fall across ranks."""
    one = torch.ones((), dtype=torch.float32, device=g.xyz.device)

    def count(total) -> torch.Tensor:
        return torch.clamp(total * one, min=1.0) / shards

    atoms = g.atom_mask.to(torch.float32).sum() * 3.0 if g.atom_mask is not None \
        else g.xyz.numel()
    beads = g.cg_mask.to(torch.float32).sum() if g.cg_mask is not None else g.cg_z.numel()
    out = {"recon": count(atoms), "kl": count(beads)}
    if gamma != 0.0:
        ew = None
        if h_bond_weight != 1.0:
            ew = torch.where(_touches_h(g), h_bond_weight, 1.0)
        if g.bond_mask is not None:
            m = g.bond_mask.to(torch.float32)
            out["graph"] = count((m if ew is None else m * ew).sum())
        else:
            out["graph"] = count(g.bonds.shape[0] if ew is None else ew.sum())
    if eta_h != 0.0:
        h_mask = _touches_h(g).to(torch.float32)
        if g.bond_mask is not None:
            h_mask = h_mask * g.bond_mask.to(torch.float32)
        out["h_graph"] = count(h_mask.sum())
    if steric is not None:
        out["steric"] = count(steric[1].to(torch.float32).sum() * n_frames)
    return out


def steric_active(zeta) -> bool:
    """False only for a literal 0 weight; a tensor weight is always on."""
    return not (isinstance(zeta, (int, float)) and float(zeta) == 0.0)


def vae_loss(
    out: VAEOutput,
    g: FlatGraph,
    beta: float,
    gamma: float,
    legacy_kl: bool = False,
    zeta=0.0,
    steric: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    h_bond_weight: float = 1.0,
    eta_h: float = 0.0,
    denominators: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """total = recon + beta*KL + gamma*graph (utils.py:141) [+ zeta * the
    steric hinge] [+ eta_h * the graph MSE over H-touching edges];
    ``h_bond_weight`` reweights H-touching edges inside the graph mean.

    The steric term, with its ``"steric"`` metric, is present when
    ``steric`` holds the (thresh, pair_mask) tables and ``zeta`` is not a
    literal 0: a tensor ``zeta`` (the warm-up ramp, read on the device) is
    always present, scaled by its value, as the JAX package's traced zeta
    is. Metrics are 0-d tensors on the loss's device. ``denominators``
    (``loss_denominators``) replace each term's own count."""
    d = denominators or {}
    if out.mu is not None:
        loss_kl = kl_divergence(
            out.mu, out.sigma, out.prior_mu, out.prior_sigma,
            legacy=legacy_kl, mask=g.cg_mask, denom=d.get("kl"),
        )
    else:
        loss_kl = torch.zeros((), device=out.xyz.device)
    loss_recon = recon_loss(out.xyz, out.xyz_recon, g.atom_mask, d.get("recon"))
    if gamma != 0.0:
        ew = None
        if h_bond_weight != 1.0:
            ew = torch.where(_touches_h(g), h_bond_weight, 1.0)
        loss_graph = graph_loss(out.xyz, out.xyz_recon, g.bonds, g.bond_mask,
                                edge_weight=ew, denom=d.get("graph"))
    else:
        loss_graph = torch.zeros((), device=out.xyz.device)
    total = loss_recon + beta * loss_kl + gamma * loss_graph
    metrics = {"loss": total, "recon": loss_recon, "kl": loss_kl,
               "graph": loss_graph}
    if steric_active(zeta) and steric is not None:
        loss_steric = steric_loss(out.xyz_recon, steric[0], steric[1], d.get("steric"))
        total = total + zeta * loss_steric
        metrics["loss"] = total
        metrics["steric"] = loss_steric
    if eta_h != 0.0:
        h_mask = _touches_h(g).to(torch.float32)
        if g.bond_mask is not None:
            h_mask = h_mask * g.bond_mask.to(torch.float32)
        loss_h = graph_loss(out.xyz, out.xyz_recon, g.bonds, bond_mask=h_mask,
                            denom=d.get("h_graph"))
        total = total + eta_h * loss_h
        metrics["loss"] = total
        metrics["h_graph"] = loss_h
    return total, metrics
