"""The cell-list radius graph (port of
``coarsegrainingvae_tpu.native.cell_list``): ctypes over
``native/cell_list.cpp``, O(N) per frame, threaded over frames.
``data/neighbors.py`` routes N >= 256 here; its dense numpy path is the
plain version, with the same edges (in another order within a receiver)
and the same mask.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from coarsegrainingvae_tpu_torch.native.build import load

# calls of radius_graph_frames in this process (a run can check its route)
calls = 0


_F32, _I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
_SYMBOLS = {
    "radius_graph_frames_cell": (
        [_F32, _I64, _I64, ctypes.c_float, _I64, ctypes.c_int,
         ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint8),
         ctypes.POINTER(ctypes.c_int64)], ctypes.c_int),
    "radius_graph_frames_count": ([_F32, _I64, _I64, ctypes.c_float, ctypes.c_int], _I64),
}


def _lib() -> ctypes.CDLL:
    return load("cell_list", _SYMBOLS)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def radius_graph_frames(
    frames: np.ndarray,
    cutoff: float,
    max_edges: Optional[int] = None,
    directed: bool = True,
    bucket: int = 128,
) -> Tuple[np.ndarray, np.ndarray]:
    """The contract of ``data.neighbors.radius_graph_frames``: edges
    (F, E_max, 2) int32 in ascending receiver order, padded with
    (N-1, N-1) rows, and mask (F, E_max) bool. A frame past ``max_edges``
    raises ValueError."""
    global calls
    lib = _lib()
    calls += 1
    frames = np.ascontiguousarray(frames, dtype=np.float32)
    f, n, _ = frames.shape

    if max_edges is None:
        m = int(lib.radius_graph_frames_count(
            _ptr(frames, ctypes.c_float), f, n, ctypes.c_float(cutoff), int(directed)))
        max_edges = ((m + bucket - 1) // bucket) * bucket if m else bucket

    # the C++ emits each frame's edges receiver by receiver, so the
    # (n-1, n-1) padding keeps the receiver column sorted
    edges = np.full((f, max_edges, 2), n - 1, dtype=np.int32)
    mask = np.zeros((f, max_edges), dtype=np.uint8)
    counts = np.zeros((f,), dtype=np.int64)
    rc = lib.radius_graph_frames_cell(
        _ptr(frames, ctypes.c_float), f, n, ctypes.c_float(cutoff),
        max_edges, int(directed),
        _ptr(edges, ctypes.c_int32), _ptr(mask, ctypes.c_uint8),
        _ptr(counts, ctypes.c_int64),
    )
    if rc != 0:
        raise ValueError(f"edge budget {max_edges} exceeded (max needed {counts.max()})")
    return edges, mask.astype(bool)
