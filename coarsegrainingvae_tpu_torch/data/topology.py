"""Per-topology precomputation (port of ``coarsegrainingvae_tpu.data.topology``).

These quantities depend only on the molecular topology and the CG mapping,
so they are computed once on the host with numpy: the bonded adjacency, the
high-order bonded edges of the graph loss, the bond-contracted CG graph,
the per-bead channel index of every atom (CG2ChannelIdx, cgvae.py:451-460 of
the original code) and its largest count, the CG graph's connectivity
check, and the bonded angle and dihedral index tuples of the DiffPool
dataset.
"""
from __future__ import annotations

import numpy as np


def adjacency_from_edges(edges: np.ndarray, n: int) -> np.ndarray:
    adj = np.zeros((n, n), dtype=np.int64)
    if edges.shape[0]:
        adj[edges[:, 0], edges[:, 1]] = 1
        adj[edges[:, 1], edges[:, 0]] = 1
    return adj


def high_order_edges(edges: np.ndarray, order: int, n_atoms: int) -> np.ndarray:
    """All node pairs within graph distance <= order
    (get_higher_order_adj_matrix, data.py:25-40 + get_high_order_edge,
    datasets.py:447-457 of the original code), by a breadth-first search
    over adjacency lists. Returns upper-triangular (e, 2) int32 pairs,
    sorted."""
    nbrs: list = [[] for _ in range(n_atoms)]
    for a, b in np.asarray(edges, dtype=np.int64):
        nbrs[a].append(int(b))
        nbrs[b].append(int(a))

    out = []
    for i in range(n_atoms):
        frontier = {i}
        seen = {i}
        for _ in range(order):
            frontier = {
                k for j in frontier for k in nbrs[j] if k not in seen
            }
            seen |= frontier
        out.extend((i, j) for j in seen if j > i)
    if not out:
        return np.zeros((0, 2), np.int32)
    return np.asarray(sorted(out), dtype=np.int32)


def cg_graph_from_bonds(
    bonds: np.ndarray, mapping: np.ndarray, n_atoms: int, n_cgs: int
) -> np.ndarray:
    """CG neighbor list contracted from the bonded atom graph -- the
    cg_cutoff=None path (data.py:227-248). Returns directed (e, 2) int32."""
    adj = adjacency_from_edges(bonds, n_atoms).astype(np.float64)
    assign = np.zeros((n_atoms, n_cgs))
    assign[np.arange(n_atoms), mapping] = 1.0
    cg_adj = assign.T @ adj @ assign
    pairs = np.argwhere(cg_adj > 0)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]]
    return pairs.astype(np.int32)


def channel_index_from_mapping(mapping: np.ndarray) -> np.ndarray:
    """Per-bead channel index of each atom (CG2ChannelIdx, cgvae.py:451-460).

    Atoms mapped to the same CG bead get channels 0,1,2,... in atom order.
    """
    mapping = np.asarray(mapping)
    out = np.zeros_like(mapping, dtype=np.int32)
    for cg in np.unique(mapping):
        idx = np.flatnonzero(mapping == cg)
        out[idx] = np.arange(idx.shape[0], dtype=np.int32)
    return out


def max_atoms_per_bead(mapping: np.ndarray) -> int:
    _, counts = np.unique(np.asarray(mapping), return_counts=True)
    return int(counts.max())


def check_cg_connected(cg_edges: np.ndarray, n_cgs: int) -> bool:
    """Whether the CG graph of ``n_cgs`` beads with edges ``cg_edges``
    (any (e, 2) int array) is connected: union-find with path halving, as
    topology.py:91 of the JAX package (check_CGgraph of the original code's
    scripts/utils.py:40-52, there with networkx)."""
    parent = list(range(n_cgs))

    def find(a: int) -> int:
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for i, j in np.asarray(cg_edges).reshape(-1, 2):
        ri, rj = find(int(i)), find(int(j))
        if ri != rj:
            parent[ri] = rj
    return len({find(i) for i in range(n_cgs)}) == 1


def _neighbours(bonds: np.ndarray, n_atoms: int) -> list:
    nbrs: list = [[] for _ in range(n_atoms)]
    for a, b in np.asarray(bonds):
        nbrs[int(a)].append(int(b))
        nbrs[int(b)].append(int(a))
    return nbrs


def angle_triplets(bonds: np.ndarray, n_atoms: int) -> np.ndarray:
    """All bonded angle index triplets (i, j, k): i and k distinct
    neighbours of the centre j, i < k (the bond-graph form of the original
    code's guessed angles, datasets.py:117-128). (A, 3) int32."""
    nbrs = _neighbours(bonds, n_atoms)
    out = []
    for j in range(n_atoms):
        ns = sorted(set(nbrs[j]))
        for x in range(len(ns)):
            for y in range(x + 1, len(ns)):
                out.append((ns[x], j, ns[y]))
    return np.asarray(out, np.int32) if out else np.zeros((0, 3), np.int32)


def dihedral_quads_from_bonds(bonds: np.ndarray, n_atoms: int) -> np.ndarray:
    """All proper dihedral index quads (i, j, k, l): central bond (j, k)
    in sorted order, i a neighbour of j other than k, l a neighbour of k
    other than j and i. (Q, 4) int32."""
    nbrs = _neighbours(bonds, n_atoms)
    pairs = sorted({(min(int(a), int(b)), max(int(a), int(b))) for a, b in np.asarray(bonds)})
    out = []
    for j, k in pairs:
        for i in sorted(set(nbrs[j])):
            if i == k:
                continue
            for l in sorted(set(nbrs[k])):
                if l == j or l == i:
                    continue
                out.append((i, j, k, l))
    return np.asarray(out, np.int32) if out else np.zeros((0, 4), np.int32)
