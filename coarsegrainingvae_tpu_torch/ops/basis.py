"""Radial basis and cutoff envelope (port of ``coarsegrainingvae_tpu.ops.basis``).

Both operate on arbitrary-shaped distance tensors; the basis axis is
appended last.
"""
from __future__ import annotations

import math

import torch


def cosine_envelope(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    """Behler cosine cutoff: 0.5*(cos(pi*d/c)+1), zero at d >= c
    (modules.py:45-58)."""
    out = 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0)
    return torch.where(d >= cutoff, torch.zeros_like(out), out)


def painn_radial_basis(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sinc-like basis sin(n*pi*d/c)/d for n=1..n_rbf (modules.py:139-172).

    d == 0 takes the sinc limit n*pi/c; d >= cutoff gives 0.
    Returns shape d.shape + (n_rbf,).
    """
    shape_d = d[..., None]
    n = torch.arange(1, n_rbf + 1, device=d.device).to(d.dtype)
    coef = n * math.pi / cutoff
    zero = shape_d == 0.0
    denom = torch.where(zero, torch.ones_like(shape_d), shape_d)
    num = torch.where(zero, coef, torch.sin(coef * shape_d))
    out = num / denom
    return torch.where(shape_d >= cutoff, torch.zeros_like(out), out)


def gaussian_smearing(d: torch.Tensor, start: float, stop: float, n_gaussians: int,
                      centered: bool = False) -> torch.Tensor:
    """Gaussian RBF expansion (basis.py:37 of the JAX package;
    modules.py:60-72,116-136 of the original code): n_gaussians offsets
    ``linspace(start, stop)`` of the spacing's width, or centred at zero
    with the offsets as widths. Returns shape d.shape + (n_gaussians,)."""
    offset = torch.linspace(start, stop, n_gaussians, dtype=d.dtype, device=d.device)
    width = (offset[1] - offset[0]) * torch.ones_like(offset)
    if not centered:
        coeff = -0.5 / width**2
        diff = d[..., None] - offset
    else:
        coeff = -0.5 / offset**2
        diff = d[..., None]
    return torch.exp(coeff * diff**2)
