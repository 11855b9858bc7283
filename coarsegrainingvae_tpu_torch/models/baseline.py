"""Non-VAE backmapping baselines (port of
``coarsegrainingvae_tpu.models.baseline``; baseline.py:8-443 of the
original code).

Every baseline takes a fixed CG mapping and maps the bead coordinates to
all-atom coordinates:

    dist_vec (B, K, knn, 3)   the knn nearest CG edge vectors of each bead
    coeffs   = f(edge distances)              (invariant)
    dx       = sum over edges coeffs * dist_vec   (equivariant)
    recon    = bead anchor - lifted centre-of-mass offset + dx

The pooling is a one-hot average (the original code's CGpool at tau 0). The
kNN is a stable ascending sort of the bead distances, so ties go to the
lower bead index, as ``jax.lax.top_k`` gives them in the JAX package; the
order matters to the models that read the edges jointly (``equimlp2``,
``setequimlp``, ``equilinear``). Each model's ``forward(xyz)`` returns
(the coordinates its loss compares against, the reconstruction).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from coarsegrainingvae_tpu_torch.models.modules import MLP
from coarsegrainingvae_tpu_torch.ops.basis import gaussian_smearing


def fixed_pool(mapping: torch.Tensor, n_cgs: int,
               xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-hot pooling of a fixed mapping (N,): (M (N, K), M_norm, cg_xyz
    (B, K, 3), each bead at the mean of its atoms)."""
    m = nn.functional.one_hot(mapping, n_cgs).to(xyz.dtype)
    m_norm = m / (torch.sum(m, dim=0, keepdim=True) + 1e-8)
    return m, m_norm, torch.einsum("bnd,nk->bkd", xyz, m_norm)


def knn_edge_vectors(cg_xyz: torch.Tensor, knn: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The knn nearest CG-CG edge vectors x_j - x_i of each bead, itself
    excluded, nearest first and ties to the lower index: (dist_vec
    (B, K, knn, 3), dist (B, K, knn))."""
    diff = cg_xyz[:, None, :, :] - cg_xyz[:, :, None, :]        # (B, K, K, 3)
    dist = torch.sqrt(torch.sum(diff**2, dim=-1) + 1e-12)
    k_beads = cg_xyz.shape[1]
    eye = torch.eye(k_beads, dtype=dist.dtype, device=dist.device) * 1e9
    idx = torch.sort(dist + eye, dim=-1, stable=True).indices[..., :knn]
    dist_vec = torch.gather(diff, 2, idx[..., None].expand(idx.shape + (3,)))
    return dist_vec, torch.sqrt(torch.sum(dist_vec**2, dim=-1) + 1e-12)


def recenter_lift(dx: torch.Tensor, mapping: torch.Tensor, m_norm: torch.Tensor,
                  cg_xyz: torch.Tensor) -> torch.Tensor:
    """Centre-of-mass re-centring and bead anchoring shared by the
    equivariant baselines (baseline.py:207-210)."""
    cg_offset = torch.einsum("bnd,nk->bkd", dx, m_norm)
    return cg_xyz[:, mapping] - cg_offset[:, mapping] + dx


def _coeff_mlp(in_features: int, width_mult: int, depth: int, out_dim: int,
               activation: str, generator: Optional[torch.Generator]) -> MLP:
    """Linear -> [act -> Linear] * depth -> act -> Linear (baseline.py:123-127)."""
    widths = [out_dim * width_mult] * (depth + 1) + [out_dim]
    return MLP(in_features, widths, activation=activation, generator=generator)


def _small_normal(shape: tuple, generator: Optional[torch.Generator]) -> nn.Parameter:
    return nn.Parameter(0.01 * torch.randn(shape, generator=generator))


class _Baseline(nn.Module):
    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int]):
        super().__init__()
        self.n_cgs, self.n_atoms = n_cgs, n_atoms
        self.register_buffer("mapping", torch.as_tensor(np.asarray(mapping, np.int64)),
                             persistent=False)


class LinearBaseline(_Baseline):
    """x_recon = B^T (cg_xyz - centroid), against the centred frame
    (baseline.py:8-36)."""

    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int],
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_cgs, n_atoms, mapping)
        self.B = _small_normal((n_cgs, n_atoms), generator)

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, _, cg_xyz = fixed_pool(self.mapping, self.n_cgs, xyz)
        shift = torch.mean(xyz, dim=1, keepdim=True)
        return xyz - shift, torch.einsum("bkd,kn->bnd", cg_xyz - shift, self.B)


class MLPBaseline(_Baseline):
    """A flat MLP on the raw CG coordinates; not equivariant
    (baseline.py:109-147)."""

    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int], width: int = 1,
                 depth: int = 1, activation: str = "ReLU",
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_cgs, n_atoms, mapping)
        self.coeffs = _coeff_mlp(n_cgs * 3, width, depth, n_atoms * 3, activation, generator)

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, _, cg_xyz = fixed_pool(self.mapping, self.n_cgs, xyz)
        out = self.coeffs(cg_xyz.reshape(-1, self.n_cgs * 3))
        return xyz, out.reshape(-1, self.n_atoms, 3)


class EquiMLP(_Baseline):
    """A per-edge MLP of the edge length -> per-atom coefficients on the
    edge vectors (baseline.py:150-212); ``equi2`` is EquiMLP2
    (baseline.py:214-280), whose MLP reads all K * knn lengths jointly."""

    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int], knn: int = 3,
                 width: int = 1, depth: int = 1, activation: str = "ReLU",
                 equi2: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__(n_cgs, n_atoms, mapping)
        self.knn, self.equi2 = knn, equi2
        n_edges = n_cgs * knn
        self.coeffs = (_coeff_mlp(n_edges, width, depth, n_edges * n_atoms, activation, generator)
                       if equi2 else
                       _coeff_mlp(1, width, depth, n_atoms, activation, generator))

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, m_norm, cg_xyz = fixed_pool(self.mapping, self.n_cgs, xyz)
        dist_vec, d = knn_edge_vectors(cg_xyz, self.knn)
        n_edges = self.n_cgs * self.knn
        dist_vec = dist_vec.reshape(-1, n_edges, 3)
        if self.equi2:
            coeffs = self.coeffs(d.reshape(-1, n_edges)).reshape(-1, n_edges, self.n_atoms)
        else:
            coeffs = self.coeffs(d.reshape(-1, n_edges, 1))
        dx = torch.einsum("ben,bed->bnd", coeffs, dist_vec)
        return xyz, recenter_lift(dx, self.mapping, m_norm, cg_xyz)


class SetEquiMLP(_Baseline):
    """Per-bead channels (baseline.py:283-384): coefficients shaped
    (K, knn, channels); atom i reads slot (bead(i), channel(i))."""

    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int],
                 channel_idx: Sequence[int], n_channels: int, knn: int = 3, width: int = 1,
                 depth: int = 1, activation: str = "ReLU",
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_cgs, n_atoms, mapping)
        self.knn, self.n_channels = min(knn, n_cgs - 1), n_channels
        self.register_buffer("channel", torch.as_tensor(np.asarray(channel_idx, np.int64)),
                             persistent=False)
        self.coeffs = _coeff_mlp(n_cgs * self.knn, width, depth,
                                 n_cgs * self.knn * n_channels, activation, generator)

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, m_norm, cg_xyz = fixed_pool(self.mapping, self.n_cgs, xyz)
        dist_vec, d = knn_edge_vectors(cg_xyz, self.knn)             # (B, K, knn, 3)
        coeffs = self.coeffs(d.reshape(-1, self.n_cgs * self.knn)).reshape(
            -1, self.n_cgs, self.knn, self.n_channels)
        dx_chan = torch.einsum("bkec,bked->bkcd", coeffs, dist_vec)  # (B, K, C, 3)
        # Every (bead, channel) slot is read by exactly one atom (channels
        # number a bead's atoms 0, 1, 2, ...), so the gather's backward
        # writes each slot's gradient once: its accumulation is free of
        # order, and the card gives the same bits on every call.
        dx = dx_chan[:, self.mapping, self.channel, :]               # (B, N, 3)
        return xyz, recenter_lift(dx, self.mapping, m_norm, cg_xyz)


class SetTransform(nn.Module):
    """A permutation-equivariant set layer over the edge axis
    (baseline.py:39-50)."""

    def __init__(self, feat_dim: int, activation: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.update = MLP(feat_dim, [feat_dim, feat_dim], activation=activation,
                          generator=generator)
        self.mix = MLP(feat_dim, [feat_dim, feat_dim], activation=activation,
                       generator=generator)

    def forward(self, edgeset: torch.Tensor) -> torch.Tensor:
        update = self.update(edgeset)
        return self.mix(update + torch.mean(update, dim=-2, keepdim=True))


class EdgeSetMLP(_Baseline):
    """Gaussian-smeared edge lengths -> a SetTransform stack -> per-atom
    coefficients (baseline.py:52-106)."""

    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int], knn: int = 3,
                 depth: int = 2, feat_dim: int = 32, cutoff: float = 20.0,
                 activation: str = "swish", generator: Optional[torch.Generator] = None):
        super().__init__(n_cgs, n_atoms, mapping)
        self.knn, self.feat_dim, self.cutoff = knn, feat_dim, cutoff
        self.sets = nn.ModuleList(SetTransform(feat_dim, activation, generator)
                                  for _ in range(depth))
        self.coeffs = MLP(feat_dim, [feat_dim, n_atoms], activation=activation,
                          generator=generator)

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, m_norm, cg_xyz = fixed_pool(self.mapping, self.n_cgs, xyz)
        dist_vec, d = knn_edge_vectors(cg_xyz, self.knn)
        out = gaussian_smearing(d, 0.0, self.cutoff, self.feat_dim)  # (B, K, knn, F)
        for layer in self.sets:
            out = layer(out)
        n_edges = self.n_cgs * self.knn
        coeffs = self.coeffs(out).reshape(-1, n_edges, self.n_atoms)
        dx = torch.einsum("ben,bed->bnd", coeffs, dist_vec.reshape(-1, n_edges, 3))
        return xyz, recenter_lift(dx, self.mapping, m_norm, cg_xyz)


class EquiLinear(_Baseline):
    """One linear layer over the kNN CG edge vectors (baseline.py:387-443)."""

    def __init__(self, n_cgs: int, n_atoms: int, mapping: Sequence[int], knn: int = 3,
                 generator: Optional[torch.Generator] = None):
        super().__init__(n_cgs, n_atoms, mapping)
        self.knn = knn
        self.B = _small_normal((n_atoms, n_cgs * knn), generator)

    def forward(self, xyz: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        _, m_norm, cg_xyz = fixed_pool(self.mapping, self.n_cgs, xyz)
        dist_vec, _ = knn_edge_vectors(cg_xyz, self.knn)
        dist_vec = dist_vec.reshape(-1, self.n_cgs * self.knn, 3)
        dx = torch.einsum("bed,ne->bnd", dist_vec, self.B)
        return xyz, recenter_lift(dx, self.mapping, m_norm, cg_xyz)


BASELINE_ZOO = ("linear", "mlp", "equimlp", "equimlp2", "setequimlp", "edgesetmlp",
                "equilinear")


def build_baseline(name: str, n_cgs: int, n_atoms: int, mapping, channel_idx=None,
                   n_channels: int = 0, generator: Optional[torch.Generator] = None,
                   **kwargs) -> nn.Module:
    """The zoo's dispatch (run_baseline.py:285-302). Every edge-based
    model's knn is clamped to n_cgs - 1, the number of other beads."""
    mapping = tuple(int(x) for x in mapping)
    name = name.lower()
    if "knn" in kwargs:
        kwargs["knn"] = min(int(kwargs["knn"]), n_cgs - 1)
    common = dict(n_cgs=n_cgs, n_atoms=n_atoms, mapping=mapping, generator=generator)
    if name == "linear":
        return LinearBaseline(**common)
    if name == "mlp":
        return MLPBaseline(**common, **kwargs)
    if name in ("equimlp", "equimlp2"):
        return EquiMLP(**common, equi2=name == "equimlp2", **kwargs)
    if name == "setequimlp":
        if channel_idx is None or n_channels <= 0:
            raise ValueError("setequimlp needs channel_idx and n_channels")
        return SetEquiMLP(**common, channel_idx=tuple(int(x) for x in channel_idx),
                          n_channels=n_channels, **kwargs)
    if name == "edgesetmlp":
        return EdgeSetMLP(**common, **kwargs)
    if name == "equilinear":
        return EquiLinear(**common, **kwargs)
    raise ValueError(f"unknown baseline {name!r}")
