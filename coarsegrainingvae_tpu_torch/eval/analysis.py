"""Post-hoc analysis: TICA projections, Ramachandran angles, KDE
free-energy surfaces and cv_stats aggregation (port of
``coarsegrainingvae_tpu.eval.analysis``).

TICA is the time-lagged covariance generalised eigenproblem in numpy (the
original code used pyemma, postanalysis.py:25-68). Ramachandran angles come
from the port's ``ops.geometry.dihedral`` given phi/psi index quads (on
``device``, "cuda" unless the caller asks for the CPU); the free-energy
surface is scipy's Gaussian KDE, and its plot imports matplotlib only when
it is drawn.
"""
from __future__ import annotations

import csv
import glob
import os
from typing import Dict, List, Tuple

import numpy as np


def tica(
    features: np.ndarray, lag: int = 10, dim: int = 2, eps: float = 1e-6
) -> Tuple[np.ndarray, np.ndarray]:
    """Time-lagged independent component analysis.

    features: (T, F) per-frame features. Returns (projection (T, dim),
    components (F, dim)). Solves the symmetrised time-lagged covariance
    generalised eigenproblem C_tau v = lambda C_0 v.
    """
    x = np.asarray(features, np.float64)
    x = x - x.mean(0)
    t = x.shape[0] - lag
    if t <= 1:
        raise ValueError("trajectory shorter than lag")
    x0, x1 = x[:-lag], x[lag:]
    c0 = (x0.T @ x0 + x1.T @ x1) / (2 * t)
    ct = (x0.T @ x1 + x1.T @ x0) / (2 * t)
    c0 += eps * np.eye(c0.shape[0])

    # whiten, then an ordinary symmetric eigenproblem
    w, u = np.linalg.eigh(c0)
    keep = w > eps
    whiten = u[:, keep] / np.sqrt(w[keep])
    m = whiten.T @ ct @ whiten
    lam, v = np.linalg.eigh((m + m.T) / 2)
    order = np.argsort(lam)[::-1][:dim]
    comps = whiten @ v[:, order]
    return x @ comps, comps


def pairwise_distance_features(xyz: np.ndarray, stride: int = 1) -> np.ndarray:
    """(T, N, 3) -> (T, N*(N-1)/2) pairwise distances, the default TICA
    featurisation for small molecules."""
    xyz = np.asarray(xyz)[::stride]
    n = xyz.shape[1]
    iu = np.triu_indices(n, k=1)
    return np.linalg.norm(xyz[:, iu[0]] - xyz[:, iu[1]], axis=-1)


def phi_psi_quads(atom_names, mapping) -> Tuple[np.ndarray, np.ndarray]:
    """phi/psi index quads from per-atom names and the per-atom residue
    index (what pyemma's featurizer gave plots.py:88-101):
    phi(i) = C(i-1), N(i), CA(i), C(i); psi(i) = N(i), CA(i), C(i), N(i+1),
    over residues whose backbone atoms are all present. Returns
    (phi (P, 4), psi (Q, 4)) int32."""
    mapping = np.asarray(mapping)
    n_res = int(mapping.max()) + 1 if mapping.size else 0
    slot = {"N": 0, "CA": 1, "C": 2}
    bb = -np.ones((n_res, 3), np.int64)
    for ai, nm in enumerate(atom_names):
        s = slot.get(str(nm))
        if s is not None:
            bb[mapping[ai], s] = ai
    phis, psis = [], []
    for i in range(n_res):
        if i > 0 and bb[i - 1, 2] >= 0 and np.all(bb[i] >= 0):
            phis.append([bb[i - 1, 2], bb[i, 0], bb[i, 1], bb[i, 2]])
        if i + 1 < n_res and np.all(bb[i] >= 0) and bb[i + 1, 0] >= 0:
            psis.append([bb[i, 0], bb[i, 1], bb[i, 2], bb[i + 1, 0]])
    return (np.asarray(phis, np.int32) if phis else np.zeros((0, 4), np.int32),
            np.asarray(psis, np.int32) if psis else np.zeros((0, 4), np.int32))


def ramachandran(xyz: np.ndarray, phi_quads: np.ndarray, psi_quads: np.ndarray,
                 device="cuda") -> Tuple[np.ndarray, np.ndarray]:
    """Backbone (phi, psi) angles per frame, radians. xyz (T, N, 3).
    Returns (T, n_phi), (T, n_psi) as numpy."""
    import torch

    from coarsegrainingvae_tpu_torch.ops.geometry import dihedral

    x = torch.as_tensor(np.asarray(xyz, np.float32), device=device)
    out = []
    for quads in (phi_quads, psi_quads):
        q = torch.as_tensor(np.asarray(quads, np.int64).reshape(-1, 4), device=device)
        out.append(torch.stack([dihedral(f, q) for f in x]).cpu().numpy()
                   if len(x) else np.zeros((0, len(q)), np.float32))
    return out[0], out[1]


def kde_free_energy(x: np.ndarray, y: np.ndarray, grid: int = 100,
                    kT: float = 1.0) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """2D Gaussian-KDE free-energy surface F = -kT log p, shifted to a
    minimum of 0 (plots.py:61-85). Returns (X, Y, F) meshgrid arrays."""
    from scipy.stats import gaussian_kde

    kde = gaussian_kde(np.vstack([x, y]))
    xg, yg = np.meshgrid(np.linspace(x.min(), x.max(), grid),
                         np.linspace(y.min(), y.max(), grid))
    p = kde(np.vstack([xg.ravel(), yg.ravel()])).reshape(grid, grid)
    f = -kT * np.log(p + 1e-12)
    f -= f.min()
    return xg, yg, f


def plot_free_energy(x, y, path: str, grid: int = 100) -> None:
    """Contour plot of the KDE free energy to ``path`` (matplotlib, Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    xg, yg, f = kde_free_energy(x, y, grid)
    fig, ax = plt.subplots(figsize=(5, 4))
    c = ax.contourf(xg, yg, f, levels=30)
    fig.colorbar(c, ax=ax, label="free energy / kT")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)


def read_csv_rows(path: str) -> List[Dict[str, str]]:
    with open(path) as f:
        return list(csv.DictReader(f))


def get_cv_stats(logdir: str) -> Dict[str, Tuple[float, float]]:
    """Aggregate a run's cv_stats.csv into mean/std per metric
    (plots.py:21-44)."""
    rows = read_csv_rows(os.path.join(logdir, "cv_stats.csv"))
    out: Dict[str, Tuple[float, float]] = {}
    if not rows:
        return out
    for key in rows[0]:
        try:
            vals = np.array([float(r[key]) for r in rows])
        except ValueError:
            continue
        out[key] = (float(np.nanmean(vals)), float(np.nanstd(vals)))
    return out


def collect_runs(pattern: str) -> Dict[str, Dict[str, Tuple[float, float]]]:
    """Aggregate many run dirs (plots.py:46-59,138-169): ``pattern`` is a
    glob over logdirs."""
    return {
        d: get_cv_stats(d)
        for d in sorted(glob.glob(pattern))
        if os.path.exists(os.path.join(d, "cv_stats.csv"))
    }


def bond_length_distribution(xyz: np.ndarray, bonds: np.ndarray) -> np.ndarray:
    """Bonded-distance samples pooled over frames (plots.py:120-136).
    xyz (T, N, 3), bonds (E, 2) -> (T*E,)."""
    xyz = np.asarray(xyz)
    bonds = np.asarray(bonds)
    d = np.linalg.norm(xyz[:, bonds[:, 0]] - xyz[:, bonds[:, 1]], axis=-1)
    return d.reshape(-1)
