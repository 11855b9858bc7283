"""Post-hoc analysis: TICA projections and cv_stats aggregation (port of
part of ``coarsegrainingvae_tpu.eval.analysis``).

TICA is the time-lagged covariance generalised eigenproblem in numpy (the
original code used pyemma, postanalysis.py:25-68). The Ramachandran, KDE
and matplotlib plots of the JAX module are listed in ROADMAP.md.
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
