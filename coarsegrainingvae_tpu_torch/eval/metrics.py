"""Structure-quality metrics: bond-graph validity, graph-edit-distance ratio,
reconstruction/sample RMSD (port of ``coarsegrainingvae_tpu.eval.metrics``).

Host numpy, as in the JAX package: a whole ensemble (S, N, 3) is evaluated
with one batched distance-matrix pass (the original code loops over
structures with ase, scripts/sampling.py:120-239). Structures past
``large_n_threshold`` atoms (1,500 by default, as in the JAX package) go to
the C++ cell-list diff (``native/bond_diff.py``) instead, which gives the
same statistics in O(N) per structure; the dense path is its plain version.
Unlike the JAX package, a failed g++ build raises instead of falling back
to the dense path.

COVALENT_RADII are the standard covalent radii in Angstrom for Z = 1..107,
as the original code tabulates them (scripts/sampling.py:12-118).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

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


def _radii(z: np.ndarray) -> np.ndarray:
    out = np.empty(z.shape, np.float64)
    for i, zz in np.ndenumerate(z):
        out[i] = COVALENT_RADII[int(zz)]
    return out


def bond_cutoff_matrix(z: np.ndarray, scale: float = 1.3) -> np.ndarray:
    """Pairwise covalent-radius cutoffs (compute_bond_cutoff,
    sampling.py:120-126)."""
    r = _radii(z)
    return (r[None, :] + r[:, None]) * scale


def bond_graphs_batch(xyz: np.ndarray, z: np.ndarray, scale: float = 1.3) -> np.ndarray:
    """Bond adjacency for a stack of structures (get_bond_graphs,
    sampling.py:158-166). xyz: (S, N, 3), z: (N,) -> (S, N, N) int8."""
    xyz = np.asarray(xyz, np.float64)
    cutoff = bond_cutoff_matrix(z, scale)
    d = np.sqrt(((xyz[:, :, None, :] - xyz[:, None, :, :]) ** 2).sum(-1))
    bonds = (d < cutoff[None]).astype(np.int8)
    idx = np.arange(z.shape[0])
    bonds[:, idx, idx] = 0
    return bonds


def valid_ratio(ref_graph: np.ndarray, gen_graphs: np.ndarray) -> Tuple[np.ndarray, float]:
    """Exact bond-graph match ratio (count_valid_graphs,
    sampling.py:170-194). Returns (valid mask (S,), ratio)."""
    diff = (gen_graphs != ref_graph[None]).sum(axis=(1, 2))
    valid = diff == 0
    return valid, float(valid.mean()) if valid.size else 0.0


def graph_diff_ratio(ref_graph: np.ndarray, gen_graphs: np.ndarray) -> np.ndarray:
    """|net bond-count difference| / ref bond count per structure -- the
    original code's 'GED ratio' (sampling.py:186-190), kept for metric
    comparability. A structure with one missing AND one spurious bond scores
    0 here; graph_edit_ratio is the true distance."""
    net = (ref_graph[None].astype(np.int64) - gen_graphs.astype(np.int64)).sum((1, 2))
    return np.abs(net) / max(ref_graph.sum(), 1)


def graph_edit_ratio(ref_graph: np.ndarray, gen_graphs: np.ndarray) -> np.ndarray:
    """True edit distance between the bond graphs (node identity is fixed,
    so GED = number of differing edges), normalised by the reference bond
    count; 0 iff the graph matches exactly."""
    diff = (ref_graph[None] != gen_graphs).sum(axis=(1, 2))
    return diff / max(ref_graph.sum(), 1)


def compute_rmsd_batch(
    gen: np.ndarray, ref: np.ndarray, z: np.ndarray, valid: Optional[np.ndarray] = None
) -> Optional[np.ndarray]:
    """Unaligned all-atom + heavy-atom RMSD over valid structures
    (compute_rmsd, sampling.py:220-239). gen: (S,N,3), ref: (N,3).
    Returns (n_valid, 2) [all_atom, heavy] or None when nothing is valid."""
    if valid is None:
        valid = np.ones(gen.shape[0], bool)
    if not valid.any():
        return None
    sel = gen[valid]
    d2 = ((sel - ref[None]) ** 2).sum(-1)  # (S', N)
    aa = np.sqrt(d2.mean(-1))
    heavy = z != 1
    hv = np.sqrt(d2[:, heavy].mean(-1))
    return np.stack([aa, hv], axis=1)


def _graph_stats_dense(ref_xyz, gen_xyz, z, scale):
    """(valid mask, net-diff ratio, edit ratio) of gen vs ref bond graphs,
    dense O(N^2)."""
    ref = bond_graphs_batch(ref_xyz[None], z, scale)[0]
    gen = bond_graphs_batch(gen_xyz, z, scale)
    valid_mask, _ = valid_ratio(ref, gen)
    return valid_mask, graph_diff_ratio(ref, gen), graph_edit_ratio(ref, gen)


def _graph_stats_cell(ref_xyz, gen_xyz, z, scale):
    """The statistics of ``_graph_stats_dense`` from the cell-list diff:
    missing + spurious edges is the edit count, |spurious - missing| the
    net difference, an exact match has both 0. The dense graphs count each
    undirected edge twice, so the ratios carry a factor 2 over twice the
    reference's edges."""
    from coarsegrainingvae_tpu_torch.native import bond_diff

    radii = _radii(z)
    ref_edges = bond_diff.bond_graph_extract(ref_xyz, radii, scale)
    missing, spurious = bond_diff.bond_graph_diff(gen_xyz, radii, ref_edges, scale)
    denom = max(2 * ref_edges.shape[0], 1)
    valid_mask = (missing + spurious) == 0
    net = 2.0 * np.abs(spurious - missing) / denom
    edit = 2.0 * (spurious + missing) / denom
    return valid_mask, net, edit


def evaluate_samples(
    ref_xyz: np.ndarray, gen_xyz: np.ndarray, z: np.ndarray, scale: float = 1.3,
    large_n_threshold: int = 1500,
) -> Dict[str, object]:
    """Full sample-quality evaluation (eval_sample_qualities,
    sampling.py:324-333): heavy-only and all-atom validity, GED ratios,
    RMSDs over valid structures. ref_xyz: (N, 3); gen_xyz: (S, N, 3).
    Past ``large_n_threshold`` atoms the graphs are compared by the
    cell-list diff instead of dense (N, N) matrices."""
    z = np.asarray(z)
    heavy = z != 1
    stats = _graph_stats_cell if z.shape[0] > large_n_threshold else _graph_stats_dense
    valid_all_mask, ged_all, edit_all = stats(ref_xyz, gen_xyz, z, scale)
    valid_hv_mask, ged_hv, edit_hv = stats(
        ref_xyz[heavy], gen_xyz[:, heavy], z[heavy], scale)
    valid_hv = float(valid_hv_mask.mean()) if valid_hv_mask.size else 0.0
    valid_all = float(valid_all_mask.mean()) if valid_all_mask.size else 0.0

    heavy_rmsds = compute_rmsd_batch(gen_xyz, ref_xyz, z, valid_hv_mask)
    all_rmsds = compute_rmsd_batch(gen_xyz, ref_xyz, z, valid_all_mask)

    return {
        "all_rmsds": all_rmsds,           # over all-atom-valid structures
        "heavy_rmsds": heavy_rmsds,       # over heavy-valid structures
        "valid_ratio": valid_hv,          # heavy-graph exact-match ratio
        "valid_allatom_ratio": valid_all,
        "graph_val_ratio": float(ged_hv.mean()),
        "graph_allatom_val_ratio": float(ged_all.mean()),
        "graph_edit_ratio": float(edit_hv.mean()),
        "graph_allatom_edit_ratio": float(edit_all.mean()),
    }


def unaligned_rmsd_np(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.sqrt(((a - b) ** 2).sum(-1).mean()))


def tetrahedral_indices(z: np.ndarray, bonds: np.ndarray) -> dict:
    """Carbon atoms with exactly four bonded neighbours -> neighbour lists
    (get_tetra_idx, run_baseline.py:94-106)."""
    n = z.shape[0]
    nbrs: dict = {i: [] for i in range(n)}
    for a, b in np.asarray(bonds):
        nbrs[int(a)].append(int(b))
        nbrs[int(b)].append(int(a))
    return {i: sorted(nbrs[i]) for i in range(n) if int(z[i]) == 6 and len(nbrs[i]) == 4}


def compute_hch(xyz: np.ndarray, tetra_index: dict) -> float:
    """Mean squared deviation of tetrahedral-centre bond-pair cosines from
    the ideal -1/3 (compute_HCH, run_baseline.py:109-118), averaged over
    every tetrahedral centre. xyz: (S, N, 3)."""
    pairs = np.array([(a, b) for a in range(4) for b in range(a + 1, 4)])
    vals = []
    for center, nbr in tetra_index.items():
        d = xyz[:, [center], :] - xyz[:, nbr, :]            # (S, 4, 3)
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        cos = np.sum(d[:, pairs[:, 0]] * d[:, pairs[:, 1]], axis=-1)
        vals.append((cos - (-1.0 / 3.0)) ** 2)
    if not vals:
        return float("nan")
    return float(np.mean(np.concatenate(vals)))
