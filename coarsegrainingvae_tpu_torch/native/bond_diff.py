"""The cell-list bond-graph diff (port of
``coarsegrainingvae_tpu.native.bond_diff``): ctypes over
``native/bond_diff.cpp``, O(N) per structure, threaded over structures.
``eval/metrics.py`` routes structures past ``large_n_threshold`` atoms
here; its dense (S, N, N) path is the plain version.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from coarsegrainingvae_tpu_torch.native.build import load

# calls of bond_graph_diff in this process (a run can check its route)
calls = 0


_F32, _I64 = ctypes.POINTER(ctypes.c_float), ctypes.c_int64
_P64 = ctypes.POINTER(ctypes.c_int64)
_SYMBOLS = {
    "bond_graph_diff": ([_F32, _I64, _I64, _F32, ctypes.c_float, _P64, _I64, _P64, _P64],
                        None),
    "bond_graph_extract": ([_F32, _I64, _F32, ctypes.c_float, ctypes.POINTER(ctypes.c_int32),
                            _I64], _I64),
}


def _lib() -> ctypes.CDLL:
    return load("bond_diff", _SYMBOLS)


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def bond_graph_extract(xyz: np.ndarray, radii: np.ndarray, scale: float = 1.3) -> np.ndarray:
    """(i < j) covalent bond pairs of one structure (N, 3): the pairs
    closer than scale * (r_i + r_j)."""
    lib = _lib()
    xyz = np.ascontiguousarray(xyz, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    n = xyz.shape[0]
    cap = max(4 * n, 64)
    while True:
        edges = np.zeros((cap, 2), np.int32)
        count = int(lib.bond_graph_extract(
            _ptr(xyz, ctypes.c_float), n, _ptr(radii, ctypes.c_float),
            ctypes.c_float(scale), _ptr(edges, ctypes.c_int32), cap))
        if count <= cap:
            return edges[:count]
        cap = count


def bond_graph_diff(xyz: np.ndarray, radii: np.ndarray, ref_edges: np.ndarray,
                    scale: float = 1.3) -> Tuple[np.ndarray, np.ndarray]:
    """Per-structure (missing, spurious) covalent-edge counts of xyz
    (S, N, 3) against the reference (i < j) edge set."""
    global calls
    lib = _lib()
    calls += 1
    xyz = np.ascontiguousarray(xyz, np.float32)
    radii = np.ascontiguousarray(radii, np.float32)
    s, n = xyz.shape[:2]
    ref = np.asarray(ref_edges, np.int64)
    lo = np.minimum(ref[:, 0], ref[:, 1])
    hi = np.maximum(ref[:, 0], ref[:, 1])
    keys = np.ascontiguousarray(np.sort(lo * n + hi))
    missing = np.zeros((s,), np.int64)
    spurious = np.zeros((s,), np.int64)
    lib.bond_graph_diff(
        _ptr(xyz, ctypes.c_float), s, n, _ptr(radii, ctypes.c_float),
        ctypes.c_float(scale), _ptr(keys, ctypes.c_int64), keys.shape[0],
        _ptr(missing, ctypes.c_int64), _ptr(spurious, ctypes.c_int64))
    return missing, spurious
