"""Structure-grid and rotating-movie xyz exports (port of
``coarsegrainingvae_tpu.utils.visualization``; visualization.py:9-100 of
the original code).

``xyz_grid_view`` tiles an ensemble of structures on a 2D grid in one
frame; ``rotate_grid`` emits 360-degree rotation frames;
``save_grid_snapshots`` dumps the rotating movies for ensemble/data/recon/CG
the way run_ala.py:407 does. All host-side numpy and plain xyz files;
``plot_assignment`` draws DiffPool's soft assignment with matplotlib,
imported only when it draws.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from coarsegrainingvae_tpu_torch.utils.xyz import _SYMBOLS, write_xyz


def xyz_grid_view(
    xyzs: np.ndarray, grid_cols: int = 3, spacing: Optional[float] = None
) -> np.ndarray:
    """Tile structures (S, N, 3) onto a grid in the x-y plane
    (visualization.py:9-44). Returns (S, N, 3) shifted coordinates that form
    one combined frame when concatenated."""
    xyzs = np.asarray(xyzs, np.float32)
    s = xyzs.shape[0]
    centered = xyzs - xyzs.mean(axis=1, keepdims=True)
    if spacing is None:
        spacing = 2.5 * float(np.abs(centered).max(initial=1.0))
    out = centered.copy()
    for i in range(s):
        row, col = divmod(i, grid_cols)
        out[i, :, 0] += col * spacing
        out[i, :, 1] += row * spacing
    return out


def rotate_grid(xyzs: np.ndarray, n_frames: int = 36, axis: int = 1) -> np.ndarray:
    """360-degree rotation movie frames (visualization.py:46-72):
    (S, N, 3) -> (n_frames, S*N, 3) with the whole grid rotated about
    ``axis`` by 360/n_frames per frame."""
    grid = xyz_grid_view(xyzs)
    flat = grid.reshape(-1, 3)
    center = flat.mean(0)
    frames = []
    for k in range(n_frames):
        ang = 2 * np.pi * k / n_frames
        c, s = np.cos(ang), np.sin(ang)
        rot = np.eye(3)
        i, j = [a for a in range(3) if a != axis]
        rot[i, i], rot[i, j], rot[j, i], rot[j, j] = c, -s, s, c
        frames.append((flat - center) @ rot.T + center)
    return np.stack(frames)


def save_rotate_frames(
    xyzs: np.ndarray, atomic_nums: np.ndarray, path: str, n_frames: int = 36
) -> None:
    """Dump a rotating-grid movie as a multi-frame xyz file
    (visualization.py:74-100, used at run_ala.py:407)."""
    movie = rotate_grid(xyzs, n_frames)
    s = xyzs.shape[0]
    z = np.tile(np.asarray(atomic_nums), s)
    write_xyz(path, movie, z)


def save_grid_snapshots(
    ensemble: np.ndarray,
    data: np.ndarray,
    recon: np.ndarray,
    cg: np.ndarray,
    atomic_nums: np.ndarray,
    cg_nums: np.ndarray,
    outdir: str,
    n_frames: int = 36,
) -> None:
    """The four rotating movies run_ala.py saves per fold (:407)."""
    os.makedirs(outdir, exist_ok=True)
    save_rotate_frames(ensemble, atomic_nums,
                       os.path.join(outdir, "rotate_ensemble.xyz"), n_frames)
    save_rotate_frames(data, atomic_nums,
                       os.path.join(outdir, "rotate_data.xyz"), n_frames)
    save_rotate_frames(recon, atomic_nums,
                       os.path.join(outdir, "rotate_recon.xyz"), n_frames)
    save_rotate_frames(cg, cg_nums, os.path.join(outdir, "rotate_cg.xyz"), n_frames)


def plot_assignment(assign: np.ndarray, atomic_nums: Optional[np.ndarray], path: str) -> None:
    """Soft-assignment heatmap (plot_map, run_diffpool.py:32-41 of the
    original code): atoms x beads, atom rows labelled by element."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    assign = np.asarray(assign)
    fig, ax = plt.subplots(figsize=(4, max(3, assign.shape[0] * 0.12)))
    im = ax.imshow(assign, aspect="auto", cmap="viridis")
    ax.set_xlabel("CG bead")
    ax.set_ylabel("atom")
    if atomic_nums is not None:
        ax.set_yticks(range(assign.shape[0]))
        ax.set_yticklabels([_SYMBOLS.get(int(z), "X") for z in atomic_nums], fontsize=5)
    fig.colorbar(im, ax=ax, label="assignment weight")
    fig.tight_layout()
    fig.savefig(path, dpi=150)
    plt.close(fig)
