"""Minimal XYZ trajectory IO (port of ``coarsegrainingvae_tpu.utils.xyz``;
the original code used ase.io, scripts/utils.py:270-272)."""
from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_SYMBOLS = {
    1: "H", 6: "C", 7: "N", 8: "O", 16: "S", 34: "Se", 15: "P",
    9: "F", 17: "Cl", 35: "Br", 53: "I",
}
_NUMBERS = {v: k for k, v in _SYMBOLS.items()}


def write_xyz(path: str, xyzs: np.ndarray, atomic_nums: np.ndarray, comment: str = "") -> None:
    """Write (F, N, 3) frames as a multi-frame .xyz (dump_numpy2xyz parity,
    scripts/utils.py:270-272)."""
    xyzs = np.asarray(xyzs)
    if xyzs.ndim == 2:
        xyzs = xyzs[None]
    z = np.asarray(atomic_nums).ravel()
    with open(path, "w") as f:
        for frame in xyzs:
            f.write(f"{len(z)}\n{comment}\n")
            for zz, (x, y, w) in zip(z, frame):
                sym = _SYMBOLS.get(int(zz), "X")
                f.write(f"{sym} {x:.6f} {y:.6f} {w:.6f}\n")


def read_xyz(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read a multi-frame .xyz -> (atomic_nums (N,), frames (F, N, 3))."""
    frames: List[np.ndarray] = []
    z: Optional[List[int]] = None
    with open(path) as f:
        lines = f.read().splitlines()
    i = 0
    while i < len(lines):
        if not lines[i].strip():
            i += 1
            continue
        n = int(lines[i].strip())
        body = lines[i + 2 : i + 2 + n]
        frame = np.empty((n, 3))
        zz = []
        for k, ln in enumerate(body):
            parts = ln.split()
            zz.append(_NUMBERS.get(parts[0], 0))
            frame[k] = [float(p) for p in parts[1:4]]
        if z is None:
            z = zz
        frames.append(frame)
        i += 2 + n
    return np.asarray(z, np.int32), np.stack(frames)
