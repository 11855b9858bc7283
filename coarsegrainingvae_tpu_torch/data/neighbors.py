"""Neighbor-list construction on the host (port of
``coarsegrainingvae_tpu.data.neighbors``).

Radius graphs vectorized over frames in numpy and emitted as fixed-shape
padded, receiver-sorted edge arrays. From ``CELL_LIST_MIN_ATOMS`` atoms
on, ``radius_graph_frames`` takes the C++ cell list
(``native/cell_list.py``), as the JAX package does (neighbors.py:72-77):
the same edges per receiver and the same mask, in O(N) per frame. The
numpy path is its plain version. Unlike the JAX package, a failed g++
build raises instead of falling back to numpy.
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


# the JAX package's switch to the cell list (neighbors.py:72-77)
CELL_LIST_MIN_ATOMS = 256


def radius_graph_dense(xyz: np.ndarray, cutoff: float, undirected: bool = True) -> np.ndarray:
    """Radius graph (d <= cutoff, no self edges) of one frame (N, 3) via
    the dense pairwise matrix (data.py:65-82); undirected keeps the i < j
    pairs. Returns (e, 2) int32 in row-major order."""
    dist = np.sqrt(((xyz[None] - xyz[:, None]) ** 2).sum(-1))
    mask = dist <= cutoff
    np.fill_diagonal(mask, False)
    pairs = np.argwhere(mask)
    if undirected:
        pairs = pairs[pairs[:, 1] > pairs[:, 0]]
    return pairs.astype(np.int32)


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
    (N-1, N-1) rows, and mask (F, E_max) bool. N >= CELL_LIST_MIN_ATOMS
    takes the cell list (module docstring).
    """
    frames = np.asarray(frames, dtype=np.float32)
    f, n, _ = frames.shape
    if n >= CELL_LIST_MIN_ATOMS:
        from coarsegrainingvae_tpu_torch.native import cell_list

        return cell_list.radius_graph_frames(frames, cutoff, max_edges, directed, bucket)
    return radius_graph_frames_dense(frames, cutoff, max_edges, directed, bucket, chunk)


def radius_graph_frames_dense(
    frames: np.ndarray,
    cutoff: float,
    max_edges: Optional[int] = None,
    directed: bool = True,
    bucket: int = 128,
    chunk: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """The numpy path of ``radius_graph_frames`` at any N, the cell
    list's plain version: within a receiver the i < j partners come first,
    then the i > j ones, each ascending."""
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
