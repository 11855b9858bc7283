"""Loss stack: reconstruction + beta*KL + gamma*graph (port of
``coarsegrainingvae_tpu.train.losses``; utils.py:89-191 of the original
code).

The excluded-volume (steric) term, a repo extension that is off at
``zeta = 0``, is not ported yet (ROADMAP.md A8; the Trainer refuses
``zeta > 0``). ``h_bond_weight`` and ``eta_h`` are ported.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from coarsegrainingvae_tpu_torch.models.cgvae import FlatGraph, VAEOutput

EPS = 1e-6  # utils.py:15 of the original code


def kl_divergence(
    mu1: torch.Tensor,
    std1: torch.Tensor,
    mu2: Optional[torch.Tensor] = None,
    std2: Optional[torch.Tensor] = None,
    legacy: bool = False,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Diagonal-Gaussian KL (utils.py:81-86 of the original code), against
    N(0, 1) when mu2 is None, else against (mu2, std2). legacy=True divides
    the mean term by std2 instead of std2**2, as the original code does."""
    if mu2 is None:
        per_node = -0.5 * torch.sum(
            1 + torch.log(std1**2) - mu1**2 - std1**2, dim=-1
        )
    else:
        denom = std2 if legacy else std2**2
        per_node = 0.5 * (
            torch.sum(std1**2 / std2**2, -1)
            + torch.sum((mu1 - mu2) ** 2 / denom, -1)
            + torch.sum(torch.log(std2**2), -1)
            - torch.sum(torch.log(std1**2), -1)
            - mu1.shape[-1]
        )
    if mask is not None:
        m = mask.to(per_node.dtype)
        return torch.sum(per_node * m) / torch.clamp(torch.sum(m), min=1.0)
    return torch.mean(per_node)


def recon_loss(xyz: torch.Tensor, xyz_recon: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Coordinate MSE, mean over atoms and xyz (utils.py:124)."""
    sq = (xyz_recon - xyz) ** 2
    if mask is not None:
        m = mask.to(sq.dtype)[:, None]
        return torch.sum(sq * m) / torch.clamp(torch.sum(m) * 3.0, min=1.0)
    return torch.mean(sq)


def graph_loss(
    xyz: torch.Tensor, xyz_recon: torch.Tensor, bonds: torch.Tensor,
    bond_mask: Optional[torch.Tensor] = None,
    edge_weight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """MSE of bonded-edge distances between data and reconstruction
    (utils.py:127-133); ``edge_weight`` rescales edges in the weighted
    mean."""
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
        return torch.sum(sq * m) / torch.clamp(torch.sum(m), min=1.0)
    if edge_weight is not None:
        return torch.sum(sq * edge_weight) / torch.clamp(torch.sum(edge_weight), min=1.0)
    return torch.mean(sq)


def _touches_h(g: FlatGraph) -> torch.Tensor:
    return (g.z[g.bonds[:, 0]] == 1) | (g.z[g.bonds[:, 1]] == 1)


def vae_loss(
    out: VAEOutput,
    g: FlatGraph,
    beta: float,
    gamma: float,
    legacy_kl: bool = False,
    h_bond_weight: float = 1.0,
    eta_h: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """total = recon + beta*KL + gamma*graph (utils.py:141) [+ eta_h * the
    graph MSE over H-touching edges]; ``h_bond_weight`` reweights
    H-touching edges inside the graph mean. Metrics are 0-d tensors on the
    loss's device."""
    if out.mu is not None:
        loss_kl = kl_divergence(
            out.mu, out.sigma, out.prior_mu, out.prior_sigma,
            legacy=legacy_kl, mask=g.cg_mask,
        )
    else:
        loss_kl = torch.zeros((), device=out.xyz.device)
    loss_recon = recon_loss(out.xyz, out.xyz_recon, g.atom_mask)
    if gamma != 0.0:
        ew = None
        if h_bond_weight != 1.0:
            ew = torch.where(_touches_h(g), h_bond_weight, 1.0)
        loss_graph = graph_loss(out.xyz, out.xyz_recon, g.bonds, g.bond_mask,
                                edge_weight=ew)
    else:
        loss_graph = torch.zeros((), device=out.xyz.device)
    total = loss_recon + beta * loss_kl + gamma * loss_graph
    metrics = {"loss": total, "recon": loss_recon, "kl": loss_kl,
               "graph": loss_graph}
    if eta_h != 0.0:
        h_mask = _touches_h(g).to(torch.float32)
        if g.bond_mask is not None:
            h_mask = h_mask * g.bond_mask.to(torch.float32)
        loss_h = graph_loss(out.xyz, out.xyz_recon, g.bonds, bond_mask=h_mask)
        total = total + eta_h * loss_h
        metrics["loss"] = total
        metrics["h_graph"] = loss_h
    return total, metrics
