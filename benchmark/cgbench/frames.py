"""The traffic generator: dipeptide-like frames of one fixed topology,
drawn from ``--seed``.

The conformers follow the port's synthetic ``"md"`` trajectory
(``data/synthetic.py`` at commit add70c80, preset "dipeptide"): the torsions
of the rotatable heavy-chain bonds random-walk by ``torsion_step_deg``,
hop into one of three basins at a rate that falls with the arm a bond
swings, the frame is built from the base conformer by one Rodrigues
rotation per bond, Cartesian jitter is added, and each frame is turned by a
random rotation about its centroid and centred. The port's steepest-descent
relaxation is left out (the configuration lists it under ``assumed``).
Every seed gives the same topology and the same number of frames; the seed
moves only the conformations, the rows' order and the noise.
"""
from __future__ import annotations

import numpy as np

# independent streams drawn from one seed
FRAMES, ROWS, NOISE, WEIGHTS, EPOCHS = range(5)


def stream(seed: int, which: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, which])


def derived_seed(seed: int, which: int) -> int:
    """A torch generator seed for stream ``which`` of ``seed``."""
    return int(stream(seed, which).integers(2**62))


def _downstream(bonds: np.ndarray, n_atoms: int, i: int, j: int) -> np.ndarray:
    """Atoms on j's side of bond (i, j)."""
    adj = [[] for _ in range(n_atoms)]
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    seen, stack, out = {i, j}, [j], [j]
    while stack:
        for v in adj[stack.pop()]:
            if v not in seen:
                seen.add(v)
                stack.append(v)
                out.append(v)
    return np.array(sorted(out), dtype=np.int64)


def _rotations(rng: np.random.Generator, n: int) -> np.ndarray:
    """(n, 3, 3) rotations: axis ~ normal, angle a whole number of degrees."""
    vec = rng.normal(size=(n, 3))
    axis = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
    angle = np.deg2rad(rng.integers(-180, 180, size=n).astype(np.float64))
    c, s = np.cos(angle), np.sin(angle)
    C = 1.0 - c
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    return np.stack([
        np.stack([c + x * x * C, x * y * C - z * s, x * z * C + y * s], -1),
        np.stack([y * x * C + z * s, c + y * y * C, y * z * C - x * s], -1),
        np.stack([z * x * C - y * s, z * y * C + x * s, c + z * z * C], -1)], axis=-2)


def make_frames(molecule: dict, params: dict, n_frames: int, seed: int) -> np.ndarray:
    """(n_frames, N, 3) float32 frames of ``molecule`` (its ``base_xyz``,
    ``bonds`` and ``rotatable`` bonds) under the traffic's ``params``."""
    rng = stream(seed, FRAMES)
    base = np.asarray(molecule["base_xyz"], np.float64)
    bonds = np.asarray(molecule["bonds"], np.int64)
    rotatable = [tuple(r) for r in molecule["rotatable"]]
    n_atoms = base.shape[0]
    downstream = [_downstream(bonds, n_atoms, i, j) for i, j in rotatable]
    basins = np.deg2rad(np.asarray(params["basins_deg"], np.float64))
    basin_p = np.asarray(params["basin_p"], np.float64)
    width = np.deg2rad(params["basin_width_deg"])
    step = np.deg2rad(params["torsion_step_deg"])
    p_hop = np.array([min(params["hop_max"], params["hop_arm"] / max(len(ds), 1))
                      for ds in downstream])
    nrot = len(rotatable)

    theta = basins[rng.choice(len(basins), size=nrot, p=basin_p)] + rng.normal(size=nrot) * width
    walk = rng.normal(scale=step, size=(n_frames, nrot))
    hop = rng.random((n_frames, nrot)) < p_hop
    hop_to = basins[rng.integers(len(basins), size=(n_frames, nrot))] \
        + rng.normal(size=(n_frames, nrot)) * width
    thetas = np.empty((n_frames, nrot))
    for f in range(n_frames):
        theta = np.where(hop[f], hop_to[f], theta + walk[f])
        thetas[f] = theta

    xyz = np.broadcast_to(base, (n_frames,) + base.shape).copy()
    eye = np.eye(3)
    for k, ((i, j), ds) in enumerate(zip(rotatable, downstream)):
        axis = xyz[:, j] - xyz[:, i]
        axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
        a1, a2, a3 = axis[:, 0], axis[:, 1], axis[:, 2]
        zero = np.zeros_like(a1)
        K = np.stack([np.stack([zero, -a3, a2], -1), np.stack([a3, zero, -a1], -1),
                      np.stack([-a2, a1, zero], -1)], axis=1)
        c = np.cos(thetas[:, k])[:, None, None]
        s = np.sin(thetas[:, k])[:, None, None]
        R = eye[None] + s * K + (1 - c) * (K @ K)
        rel = xyz[:, ds] - xyz[:, j, None]
        xyz[:, ds] = np.einsum("fnd,fed->fne", rel, R) + xyz[:, j, None]
    xyz += rng.normal(scale=params["jitter"], size=xyz.shape)
    xyz -= xyz.mean(axis=1, keepdims=True)
    if params["rotate"]:
        xyz = np.einsum("fni,fji->fnj", xyz, _rotations(rng, n_frames))
    return xyz.astype(np.float32)


def pair_counts(frames: np.ndarray, cutoff: float, eps: float = 1e-3) -> np.ndarray:
    """Per frame, the ordered pairs i != j whose distance sqrt(r^2 + eps)
    lies below ``cutoff``: the pairs a dense message kernel weighs."""
    n = frames.shape[1]
    out = []
    for lo in range(0, frames.shape[0], 1024):
        block = frames[lo:lo + 1024]
        d2 = np.sum((block[:, :, None, :] - block[:, None, :, :]) ** 2, axis=-1)
        inside = np.sqrt(d2 + eps) < cutoff
        inside[:, np.arange(n), np.arange(n)] = False
        out.append(inside.sum(axis=(1, 2)))
    return np.concatenate(out)
