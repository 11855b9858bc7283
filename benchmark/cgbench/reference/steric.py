"""The excluded-volume (steric) term of the loss, for a configuration that
sets ``zeta``: its tables and its hinge.

A frozen copy of the port's plain code at commit add70c80:
``train/losses.py::build_steric_tables`` and ``steric_loss``, with the
covalent radii of ``eval/metrics.py`` (Z = 1..107, as the original code
tabulates them). Imports nothing of the port.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

EPS = 1e-6

_RADII_LIST = [
    0.23, 0.93, 0.68, 0.35, 0.83, 0.68, 0.68, 0.68, 0.64, 1.12,
    0.97, 1.10, 1.35, 1.20, 0.75, 1.02, 0.99, 1.57, 1.33, 0.99,
    1.44, 1.47, 1.33, 1.35, 1.35, 1.34, 1.33, 1.50, 1.52, 1.45,
    1.22, 1.17, 1.21, 1.22, 1.21, 1.91, 1.47, 1.12, 1.78, 1.56,
    1.48, 1.47, 1.35, 1.40, 1.45, 1.50, 1.59, 1.69, 1.63, 1.46,
    1.46, 1.47, 1.40, 1.98, 1.67, 1.34, 1.87, 1.83, 1.82, 1.81,
    1.80, 1.80, 1.99, 1.79, 1.76, 1.75, 1.74, 1.73, 1.72, 1.94,
    1.72, 1.57, 1.43, 1.37, 1.35, 1.37, 1.32, 1.50, 1.50, 1.70,
    1.55, 1.54, 1.54, 1.68, 1.70, 2.40, 2.00, 1.90, 1.88, 1.79,
    1.61, 1.58, 1.55, 1.53, 1.51, 1.50, 1.50, 1.50, 1.50, 1.50,
    1.50, 1.50, 1.50, 1.57, 1.49, 1.43, 1.41,
]
COVALENT_RADII = {z + 1: r for z, r in enumerate(_RADII_LIST)}


def tables(z, bonds, scale: float = 1.3, margin: float = 0.3,
           frames: Optional[np.ndarray] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(thresh (N, N) float32, pair_mask (N, N) bool): every nonbonded pair
    of real atoms, its distance floor scale * (r_i + r_j) + ``margin``; with
    ``frames`` (T, N, 3), the frames' own closest approach clipped into
    [scale * (r_i + r_j), that + ``margin``]."""
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
            np.minimum(dmin, np.sqrt(((c[:, :, None, :] - c[:, None, :, :]) ** 2).sum(-1)).min(0),
                       out=dmin)
        thresh = np.clip(dmin, base, base + margin)
    mask = real[None, :] & real[:, None]
    mask[np.arange(n), np.arange(n)] = False
    for a, b in np.asarray(bonds).reshape(-1, 2):
        mask[int(a), int(b)] = mask[int(b), int(a)] = False
    return thresh.astype(np.float32), mask


def loss(xyz_recon: torch.Tensor, thresh: torch.Tensor, pair_mask: torch.Tensor) -> torch.Tensor:
    """The mean squared hinge on nonbonded pair distances below ``thresh``,
    over every frame's masked pairs; ``xyz_recon`` (B*N, 3)."""
    n = thresh.shape[0]
    xyz = xyz_recon.reshape(-1, n, 3)
    d = torch.sqrt(torch.sum((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2, -1) + EPS)
    viol = torch.clamp(thresh[None] - d, min=0.0)
    count = torch.clamp(pair_mask.sum().to(viol.dtype) * xyz.shape[0], min=1.0)
    return torch.sum(viol**2 * pair_mask.to(viol.dtype)[None]) / count
