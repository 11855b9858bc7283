"""Neighbor-list construction on the host (port of
``coarsegrainingvae_tpu.data.neighbors``).

Radius graphs vectorized over frames in numpy and emitted as fixed-shape
padded, receiver-sorted edge arrays. The JAX package switches to a C++
cell list at N >= 256 atoms (neighbors.py:72-77), which gives the same
arrays; the port computes the numpy path at every N (the cell list is a
later slice, ROADMAP.md A5).
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def make_directed(edges: np.ndarray) -> np.ndarray:
    """Ensure an edge list contains both directions (conv.py:10-20).

    If the list is already directed (contains some i>j and some j>i rows) it
    is returned unchanged; otherwise the flipped copy is appended.
    """
    if edges.shape[0] == 0:
        return edges.reshape(0, 2).astype(np.int32)
    gtr_ij = bool((edges[:, 0] > edges[:, 1]).any())
    gtr_ji = bool((edges[:, 1] > edges[:, 0]).any())
    if gtr_ij and gtr_ji:
        return edges.astype(np.int32)
    return np.concatenate([edges, edges[:, ::-1]], axis=0).astype(np.int32)


def radius_graph_frames(
    frames: np.ndarray,
    cutoff: float,
    max_edges: Optional[int] = None,
    directed: bool = True,
    bucket: int = 128,
    chunk: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Padded radius graphs (d <= cutoff, no self edges) for a stack of
    frames (F, N, 3).

    max_edges: per-frame edge budget; None -> the largest frame's count
    rounded up to ``bucket``. directed: emit both (i, j) and (j, i). chunk:
    frames per numpy block, to bound host memory.

    Returns edges (F, E_max, 2) int32, sorted by receiver and padded with
    (N-1, N-1) rows, and mask (F, E_max) bool.
    """
    frames = np.asarray(frames, dtype=np.float32)
    f, n, _ = frames.shape

    per_frame_pairs = []
    counts = np.zeros(f, dtype=np.int64)
    iu, ju = np.triu_indices(n, k=1)
    for lo in range(0, f, chunk):
        hi = min(lo + chunk, f)
        blk = frames[lo:hi]  # (c, N, 3)
        d2 = ((blk[:, :, None, :] - blk[:, None, :, :]) ** 2).sum(-1)
        adj = d2[:, iu, ju] <= cutoff * cutoff  # (c, P) upper-tri pairs
        for k in range(hi - lo):
            sel = np.flatnonzero(adj[k])
            pairs = np.stack([iu[sel], ju[sel]], axis=1).astype(np.int32)
            if directed:
                pairs = np.concatenate([pairs, pairs[:, ::-1]], axis=0)
            pairs = pairs[np.argsort(pairs[:, 0], kind="stable")]
            per_frame_pairs.append(pairs)
            counts[lo + k] = pairs.shape[0]

    if max_edges is None:
        max_edges = int(counts.max()) if f else 0
        max_edges = ((max_edges + bucket - 1) // bucket) * bucket if max_edges else bucket

    # the (n-1, n-1) padding keeps the receiver column sorted
    edges = np.full((f, max_edges, 2), n - 1, dtype=np.int32)
    mask = np.zeros((f, max_edges), dtype=bool)
    for k, pairs in enumerate(per_frame_pairs):
        e = pairs.shape[0]
        if e > max_edges:
            raise ValueError(
                f"frame {k} has {e} edges > budget {max_edges}; raise max_edges"
            )
        edges[k, :e] = pairs
        mask[k, :e] = True
    return edges, mask
