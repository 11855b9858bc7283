"""Geometry: the sparse model's edge vectors, and the dense all-pairs
geometry shared by the message kernels' plain versions.

``preprocess_r`` and ``edge_vectors`` are the port of
``coarsegrainingvae_tpu.ops.geometry`` (geometry.py:16-30): dist =
sqrt(sum(r^2 + 1e-8)), unit = r / dist, the epsilon inside the sum keeping
masked zero-length edges finite. ``dense_pairwise`` and
``radius_adjacency`` are the port of ``coarsegrainingvae_tpu.models.dense``
(dense.py:39-63); they live in ``ops`` because the kernels' plain versions
use them as well as the DiffPool blocks of ``models/dense.py``, which run
in plain torch (the dense CGVAE's messages go through the kernels, which
rebuild the geometry on the card). ``dihedral`` and ``drmsd`` are the
PCN loss's and metrics' (geometry.py:80-124 of the JAX package);
``rotation_matrix_from_axis_angle``, ``random_rotation_matrices``,
``rotate`` and ``unaligned_rmsd`` its exported helpers (geometry.py:32-74).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from coarsegrainingvae_tpu_torch.ops.basis import cosine_envelope, painn_radial_basis

EPS = 1e-3  # the dense family's distance epsilon (diffpoolvae.py:6)


def preprocess_r(r_ij: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge displacement (..., 3) -> (distance, unit vector)."""
    dist = torch.sqrt(torch.sum(r_ij**2 + eps, dim=-1))
    return dist, r_ij / dist[..., None]


def edge_vectors(xyz: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """r_ij = x[j] - x[i] for directed edges (i = edges[:, 0] receives)."""
    return xyz[edges[:, 1]] - xyz[edges[:, 0]]


def dense_pairwise(xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xyz (B, N, 3) -> (r_ij, dist, unit) with
      r_ij[b, i, j] = xyz[b, j] - xyz[b, i]   (sender minus receiver)
      dist = sqrt(|r|^2 + EPS)
    The diagonal gets dist = sqrt(EPS), unit ~ 0.
    """
    r_ij = xyz[:, None, :, :] - xyz[:, :, None, :]
    dist = torch.sqrt(torch.sum(r_ij**2, dim=-1) + EPS)
    unit = r_ij / dist[..., None]
    return r_ij, dist, unit


def radius_adjacency(
    dist: torch.Tensor, cutoff: float, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """(B, N, N) 0/1 adjacency: strictly within cutoff, no self edges,
    masked rows and columns excluded."""
    n = dist.shape[-1]
    adj = (dist < cutoff).to(dist.dtype)
    adj = adj * (1.0 - torch.eye(n, dtype=dist.dtype, device=dist.device))
    if mask is not None:
        m = mask.to(dist.dtype)
        adj = adj * m[:, :, None] * m[:, None, :]
    return adj


def pair_filter_basis(
    xyz: torch.Tensor, mask: torch.Tensor, cutoff: float, n_rbf: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(unit, adj, k) with k = adj * env * [rbf_1..R, 1]  (B, N, N, R+1):
    the pair pipeline both fused kernels rebuild (pallas_pseudo.py:57-73)."""
    _, dist, unit = dense_pairwise(xyz)
    adj = radius_adjacency(dist, cutoff, mask)
    rbf = painn_radial_basis(dist, n_rbf, cutoff)
    rbf = torch.cat([rbf, torch.ones_like(rbf[..., :1])], dim=-1)
    k = (adj * cosine_envelope(dist, cutoff))[..., None] * rbf
    return unit, adj, k


def rotation_matrix_from_axis_angle(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rodrigues rotation matrix. axis: (..., 3) unit, angle: (...) radians."""
    x, y, z = axis[..., 0], axis[..., 1], axis[..., 2]
    c, s = torch.cos(angle), torch.sin(angle)
    cc = 1.0 - c
    row0 = torch.stack([c + x * x * cc, x * y * cc - z * s, x * z * cc + y * s], -1)
    row1 = torch.stack([y * x * cc + z * s, c + y * y * cc, y * z * cc - x * s], -1)
    row2 = torch.stack([z * x * cc - y * s, z * y * cc + x * s, c + z * z * cc], -1)
    return torch.stack([row0, row1, row2], -2)


def random_rotation_matrices(generator: torch.Generator, n: int,
                             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(n, 3, 3) random rotations (axis ~ normal, angle ~ U(-pi, pi)) drawn
    from ``generator`` on its device: the per-frame augmentation of the
    original code's dataset build (datasets.py:65-71,475)."""
    device = generator.device
    vec = torch.randn(n, 3, generator=generator, dtype=dtype, device=device)
    axis = vec / torch.linalg.norm(vec, dim=-1, keepdim=True)
    angle = (torch.rand(n, generator=generator, dtype=dtype, device=device) * 2 - 1) * math.pi
    return rotation_matrix_from_axis_angle(axis, angle)


def rotate(xyz: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Apply rotation matrices. xyz: (..., N, 3), rot: (..., 3, 3)."""
    return torch.einsum("...ni,...ij->...nj", xyz, rot.transpose(-1, -2))


def unaligned_rmsd(x: torch.Tensor, y: torch.Tensor,
                   mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RMSD without alignment, the original metric (sampling.py:220-239):
    sqrt of the mean over atoms of the squared distance; ``mask`` (..., N)
    keeps the atoms it marks."""
    sq = torch.sum((x - y) ** 2, dim=-1)
    if mask is None:
        return torch.sqrt(torch.mean(sq, dim=-1))
    m = mask.to(sq.dtype)
    return torch.sqrt(torch.sum(sq * m, dim=-1) / torch.clamp(torch.sum(m, dim=-1), min=1.0))


def dihedral(xyz: torch.Tensor, quads: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """Signed dihedral angles (radians) of (Q, 4) atom-index quads, by
    atan2. The original code's compute_dihe (pcn_utils.py:114-132) takes
    arctan(p1/p2), which loses the quadrant; the JAX package fixes that,
    and so does the port."""
    p0, p1, p2, p3 = (xyz[quads[:, k]] for k in range(4))
    b1 = p1 - p0
    b2 = p2 - p1
    b3 = p3 - p2
    c1 = torch.linalg.cross(b2, b3)
    c2 = torch.linalg.cross(b1, b2)
    b2n = torch.sqrt(torch.sum(b2**2, -1) + eps)
    y = torch.sum(b1 * c1, -1) * b2n
    x = torch.sum(c1 * c2, -1)
    return torch.atan2(y, x + eps)


def drmsd(x: torch.Tensor, y: torch.Tensor, mask: Optional[torch.Tensor] = None
          ) -> torch.Tensor:
    """Distance-matrix RMSD over atom pairs i < j (run_pdb.py:20-31):
    sqrt(mean (d_ij(x) - d_ij(y))^2). x, y (N, 3); mask (N,) bool."""
    dx = torch.sqrt(torch.sum((x[:, None] - x[None]) ** 2, -1) + 1e-12)
    dy = torch.sqrt(torch.sum((y[:, None] - y[None]) ** 2, -1) + 1e-12)
    n = x.shape[0]
    triu = torch.triu(torch.ones((n, n), dtype=torch.bool, device=x.device), diagonal=1)
    if mask is not None:
        triu = triu & (mask[:, None] & mask[None, :])
    w = triu.to(dx.dtype)
    return torch.sqrt(torch.sum((dx - dy) ** 2 * w) / torch.clamp(torch.sum(w), min=1.0))
