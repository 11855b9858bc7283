"""Synthetic molecular-dynamics-like ensembles.

The original code pulls alanine-dipeptide / pentapeptide trajectories from
mdshare and proteins from disk (datasets.py:24-40,170-187). This module
generates topologically realistic stand-ins without any MD IO library: a heavy-atom chain with tetrahedral geometry, attached hydrogens,
and per-frame conformations sampled by rotating random rotatable bonds
between Ramachandran-like torsion basins plus thermal jitter. The resulting
ensembles have a fixed bonded topology (so bond-graph validity metrics are
meaningful) and multi-modal conformational diversity (so the VAE has
something to learn).

PyTorch port of ``coarsegrainingvae_tpu.data.synthetic``: the peptide
presets and the atom14 proteins of the PCN path (``synthetic_protein``).
The generators are the same numpy code; ``relax_frames`` and the atom14
relaxation are the same steepest descent written in torch on an explicit
device.
"""
from __future__ import annotations

from typing import Tuple, Union

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.ops.segment import segment_sum

# bump whenever generation/relaxation changes so on-disk ensemble caches
# (data/proteins.py) are invalidated instead of silently served stale
SYNTH_VERSION = 7  # v7: vdW-like nonbonded relax margin on ALL peptide presets

# dipeptide stand-in matches alanine dipeptide's size: 22 atoms, 10 heavy.
# ou_kappa / hop_scale shape the "md" trajectory statistics per preset:
# ou_kappa > 0 makes torsions mean-revert to the initial (folded) reference
# conformer with stationary std sigma_step/sqrt(2*kappa), and hop_scale
# thins the basin-hop rate -- a folded miniprotein at 300 K is
# basin-dominated with occasional excursions (DESRES chignolin,
# original README.md:61-64), NOT a free random walk in torsion
# space. ou_kappa=0 / hop_scale=1 (dipeptide, pentapeptide) reproduce the
# v4 free-diffusion statistics bit-identically.
#
# relax_margin is the nonbonded floor in units of the 1.3x covalent
# cutoff (relax_frames margin). Real molecules keep nonbonded atoms at
# van-der-Waals separations FAR outside covalent cutoffs (H..H vdW
# ~2.2 A vs the 0.81 A H-H covalent cutoff); the 1.15 default leaves
# nonbonded pairs unphysically close to the bonded/nonbonded decision
# boundary, which makes exact-graph validity brittle in a way real MD
# frames are not. All presets use a vdW-like 1.30 (v7).
_PRESETS = {
    # v7: the 1.15 default relax margin left occasional frames with
    # near-clashing nonbonded pairs (collapsed bead geometry); one such
    # frame in a 16k-frame fold blew the fold's test recon RMSD to 7e5
    # (examples/results/dipeptide_5fold/README.md). All presets now use
    # the vdW-like 1.30 floor chignolin already used.
    "dipeptide": dict(n_heavy=10, n_frames_default=20000, relax_margin=1.30),
    "pentapeptide": dict(n_heavy=40, n_frames_default=10000,
                         relax_margin=1.30),
    "chignolin": dict(n_heavy=77, n_frames_default=5000,
                      ou_kappa=0.15, hop_scale=0.25, relax_margin=1.30),
    # spike-protein scale (reference datasets.py:24-26 'covid', the DESRES
    # SARS-CoV-2 spike trajectory; README.md:82): ~10k atoms.
    # rotatable_stride=4 leaves ~1 torsion per 4 heavy bonds -- rigid
    # segments between hinges, like secondary structure -- which keeps the
    # host-side conformer generation tractable at this size (per-frame
    # cost scales with n_rotatable * N).
    "covid": dict(n_heavy=3800, n_frames_default=240,
                  ou_kappa=0.15, hop_scale=0.25, relax_margin=1.30,
                  rotatable_stride=4),
}

_BOND_CC = 1.52
_BOND_CH = 1.09
_TET = np.deg2rad(109.5)


def _base_geometry(n_heavy: int, rng: np.random.Generator):
    """Zig-zag heavy chain + hydrogens; returns (z, xyz, bonds, rotatable)."""
    heavy_z = rng.choice([6, 6, 6, 7, 8], size=n_heavy, p=[0.5, 0.2, 0.1, 0.1, 0.1])
    heavy_z[0] = 6
    pos = np.zeros((n_heavy, 3))
    direction = np.array([1.0, 0.0, 0.0])
    up = np.array([0.0, 1.0, 0.0])
    for i in range(1, n_heavy):
        # alternate bond direction to make a tetrahedral zig-zag: +/-(pi-TET)/2
        # off the chain axis gives vertex bond angles of TET (109.5 deg), so
        # heavy 1-3 distances sit at 2.48 A, well OUTSIDE the 1.77 A covalent
        # cutoff (the former +/-TET/2 compressed angles to 70.5 deg -> 1.75 A,
        # structurally inside the cutoff)
        ang = (np.pi - _TET) / 2 if i % 2 == 0 else -(np.pi - _TET) / 2
        c, s = np.cos(ang), np.sin(ang)
        d = c * direction + s * up
        d = d / np.linalg.norm(d)
        pos[i] = pos[i - 1] + _BOND_CC * d
    bonds = [(i - 1, i) for i in range(1, n_heavy)]

    # attach 1-2 hydrogens per carbon/nitrogen (valence-ish), none on O
    h_pos, h_parent = [], []
    for i in range(n_heavy):
        n_h = {6: 2, 7: 1, 8: 0}[int(heavy_z[i])]
        if i == 0 or i == n_heavy - 1:
            n_h = min(n_h + 1, 3)
        for k in range(n_h):
            phi = 2 * np.pi * (k + 1) / 3.0 + (0.5 if i % 2 else 0.0)
            off = np.array([0.0, np.cos(phi), np.sin(phi)])
            off = off - np.dot(off, direction) * direction * 0.3
            off = off / np.linalg.norm(off)
            h_pos.append(pos[i] + _BOND_CH * off)
            h_parent.append(i)

    n_h_total = len(h_pos)
    z = np.concatenate([heavy_z, np.ones(n_h_total)]).astype(np.int32)
    xyz = np.concatenate([pos, np.array(h_pos).reshape(-1, 3)], axis=0)
    bonds += [(p, n_heavy + k) for k, p in enumerate(h_parent)]
    bonds = np.array(bonds, dtype=np.int32)

    # rotatable bonds: interior heavy-chain bonds
    rotatable = [(i - 1, i) for i in range(2, n_heavy - 1)]
    return z, xyz, bonds, rotatable


def _downstream_atoms(bonds: np.ndarray, n_atoms: int, i: int, j: int) -> np.ndarray:
    """Atoms on j's side of bond (i, j) via BFS with edge (i,j) removed."""
    adj = [[] for _ in range(n_atoms)]
    for a, b in bonds:
        adj[a].append(b)
        adj[b].append(a)
    seen = {i, j}
    stack = [j]
    out = [j]
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if v not in seen:
                seen.add(v)
                stack.append(v)
                out.append(v)
    return np.array(sorted(out), dtype=np.int64)


def _bond_masks(z: np.ndarray, bonds: np.ndarray, scale: float = 1.3):
    """(bonded+diag mask (N,N), covalent cutoff matrix (N,N))."""
    from coarsegrainingvae_tpu_torch.eval.metrics import COVALENT_RADII

    n = z.shape[0]
    r = np.array([COVALENT_RADII[int(s)] for s in z], np.float64)
    cutoff = scale * (r[:, None] + r[None, :])
    bonded = np.eye(n, dtype=bool)
    bonded[bonds[:, 0], bonds[:, 1]] = True
    bonded[bonds[:, 1], bonds[:, 0]] = True
    return bonded, cutoff


def graph_violations(
    z: np.ndarray, frames: np.ndarray, bonds: np.ndarray, band: float = 1.0
) -> np.ndarray:
    """Per-frame count of bond-graph disagreements with the topology under
    the covalent-cutoff rule (reference scripts/sampling.py:158-194).
    band > 1 demands a safety margin on both sides of the cutoff."""
    bonded, cutoff = _bond_masks(z, bonds)
    x_all = np.asarray(frames, np.float64)
    f_total, n = x_all.shape[:2]
    bi, bj = bonds[:, 0], bonds[:, 1]
    out = np.empty(f_total, np.int64)
    # frame-chunked with a Gram-matrix distance: at spike scale (10k atoms)
    # the naive (F, N, N, 3) diff tensor is terabytes; d^2 = |x|^2 + |x|^2^T
    # - 2 x x^T keeps the transient at one (chunk, N, N) matrix
    chunk = max(1, (1 << 27) // max(n * n, 1))
    for s in range(0, f_total, chunk):
        x = x_all[s : s + chunk]
        sq = (x**2).sum(-1)
        d2 = sq[:, :, None] + sq[:, None, :] - 2.0 * np.einsum(
            "fnd,fmd->fnm", x, x
        )
        d = np.sqrt(np.maximum(d2, 0.0))
        np.einsum("fii->fi", d)[:] = 1e9
        nb_bad = (d < cutoff[None] * band) & ~bonded
        bond_bad = d[:, bi, bj] > cutoff[bi, bj] / band
        out[s : s + chunk] = nb_bad.sum((1, 2)) // 2 + bond_bad.sum(1)
    return out


def relax_frames(
    z: np.ndarray,
    frames: np.ndarray,
    bonds: np.ndarray,
    rest: np.ndarray,
    margin: float = 1.15,
    step: float = 0.2,
    n_iter: int = 300,
    device: Union[str, torch.device] = "cuda",
) -> np.ndarray:
    """Steepest-descent on a bond + soft-sphere potential so every frame's
    covalent-distance bond graph equals the intended topology.

    Why: the headline metric is EXACT bond-graph match against covalent
    cutoffs 1.3*(r_i+r_j) (scripts/sampling.py:158-194 of the original
    code); raw torsion-sampled stand-in conformers contain steric clashes
    that make that metric structurally zero. Energy terms:
      bonds:      (d_ij - rest_ij)^2         -> keeps real bonds inside cutoff
      non-bonded: max(margin*cutoff - d, 0)^2 -> pushes clashes outside cutoff
    A fixed-iteration float32 loop over frame chunks on ``device``; the
    decaying step damps oscillation. The bond forces go into their atoms
    through ``segment_sum`` over the endpoints in a fixed order (not an
    index-add, whose float atomics on a card sum in the order the threads
    arrive and the 300 steps amplify), so the card gives the same bits on
    every call and in every process. frames: (F, N, 3); returns a float64
    copy.
    """
    from coarsegrainingvae_tpu_torch.eval.metrics import COVALENT_RADII

    device = torch.device(device)
    n = z.shape[0]
    radii = torch.tensor([COVALENT_RADII[int(s)] for s in z],
                         dtype=torch.float32, device=device)
    bi = torch.as_tensor(np.asarray(bonds[:, 0]), dtype=torch.long, device=device)
    bj = torch.as_tensor(np.asarray(bonds[:, 1]), dtype=torch.long, device=device)
    rest_t = torch.as_tensor(np.asarray(rest), dtype=torch.float32, device=device)
    ends = torch.cat([bi, bj])
    order = torch.argsort(ends, stable=True)
    ends = ends[order]

    # pair threshold margin*1.3*(r_i + r_j), zero on bonded pairs and the
    # diagonal (those are held by the bond term / excluded)
    thr = 1.3 * margin * (radii[:, None] + radii[None, :])
    thr[bi, bj] = 0.0
    thr[bj, bi] = 0.0
    thr.fill_diagonal_(0.0)
    eye = torch.eye(n, dtype=torch.float32, device=device)
    # the step schedule is evaluated in float32, as the jitted JAX loop does
    lrs = [float(np.float32(step) / (np.float32(1.0) + np.float32(0.02) * np.float32(it)))
           for it in range(n_iter)]

    def run(x: torch.Tensor) -> torch.Tensor:
        for lr in lrs:
            diff = x[:, :, None, :] - x[:, None, :, :]
            d = torch.sqrt((diff**2).sum(-1) + eye)
            nb_viol = torch.clamp(thr[None] - d, min=0.0)
            force = ((nb_viol / d)[..., None] * diff).sum(2)
            dbond = d[:, bi, bj]
            fb = ((dbond - rest_t) / dbond)[..., None] * diff[:, bi, bj]
            # (2E, F, 3) rows sorted by atom -> (N, F, 3) sums -> (F, N, 3)
            rows = torch.cat([-fb, fb], dim=1)[:, order].transpose(0, 1)
            force = force + segment_sum(rows, ends, n, indices_are_sorted=True).transpose(0, 1)
            x = x + lr * force
        return x

    f_total = frames.shape[0]
    chunk = max(1, min(2048, (1 << 22) // (n * n)))
    out = np.empty((f_total, n, 3), np.float64)
    for s in range(0, f_total, chunk):
        block = torch.as_tensor(np.asarray(frames[s : s + chunk], np.float32),
                                device=device)
        out[s : s + chunk] = run(block).cpu().numpy().astype(np.float64)
    return out


def synthetic_peptide(
    name: str = "dipeptide",
    n_frames: int = 2000,
    seed: int = 123,
    jitter: float = 0.04,
    torsion_diversity: bool = True,
    traj_mode: str = "md",
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate (atomic_nums (N,), frames (F,N,3) Angstrom, bonds (Eb,2)).

    Frames are conformers of one fixed topology: torsions of rotatable
    backbone bonds live in 3 Gaussian basins (trans/gauche+/gauche-), plus
    Cartesian thermal noise, then relaxed (relax_frames) so the
    covalent-cutoff bond graph of every frame equals the bonded topology
    -- making exact-match validity metrics meaningful on this stand-in data.

    traj_mode:
      "md" (default, round 3) -- frames form a TEMPORALLY CORRELATED
        trajectory: torsions random-walk (Gaussian diffusion) with
        occasional clash-gated basin hops, exactly the statistics of the
        reference's real data (contiguous 250ns/1.3GB MD trajectories,
        original README.md:41-64, shuffled before the KFold split
        like the reference's shuffle_traj). The round-2 "iid" mode drew
        every frame's basins independently -- 3^(n_rotatable) effective
        conformers, a far HARDER ensemble than any real trajectory, which
        is why the committed chignolin runs could not reach nonzero
        validity at reference hyperparameters.
      "iid" -- the round-2 behavior (independent basin draw per frame).

    torsion_diversity=False skips basin sampling: frames are jitter-only
    perturbations of the base conformer (an easy, nearly unimodal ensemble
    for fast-converging smoke tests).

    ``device`` is where relax_frames runs (the card unless the caller asks
    for the CPU); everything else is numpy.
    """
    if name not in _PRESETS:
        raise KeyError(f"unknown synthetic preset {name!r}; have {sorted(_PRESETS)}")
    rng = np.random.default_rng(seed)
    z, base, bonds, rotatable = _base_geometry(_PRESETS[name]["n_heavy"], rng)
    stride = int(_PRESETS[name].get("rotatable_stride", 1))
    if stride > 1:
        rotatable = rotatable[::stride]
    n_atoms = base.shape[0]

    # relax the base conformer first: its bond lengths become the rest
    # lengths every frame is restrained to
    rest0 = np.linalg.norm(base[bonds[:, 0]] - base[bonds[:, 1]], axis=-1)
    relax_margin = float(_PRESETS[name].get("relax_margin", 1.15))
    base = relax_frames(z, base[None], bonds, rest0, margin=relax_margin,
                        device=device)[0]
    rest = np.linalg.norm(base[bonds[:, 0]] - base[bonds[:, 1]], axis=-1)

    downstream = [
        _downstream_atoms(bonds, n_atoms, i, j) for (i, j) in rotatable
    ]
    basins = np.deg2rad(np.array([180.0, 60.0, -60.0]))
    # trans-biased so long chains start mostly clash-free (relaxation below
    # only has local work to do)
    basin_p = np.array([0.5, 0.25, 0.25])
    basin_width = np.deg2rad(15.0)

    bonded_mask, cutoff = _bond_masks(z, bonds)
    clash_cut = 1.05 * cutoff * ~bonded_mask  # nonbonded pairs only

    def _rotate(xyz, i, j, ds, angle):
        axis = xyz[j] - xyz[i]
        axis = axis / np.linalg.norm(axis)
        c, s = np.cos(angle), np.sin(angle)
        K = np.array(
            [
                [0, -axis[2], axis[1]],
                [axis[2], 0, -axis[0]],
                [-axis[1], axis[0], 0],
            ]
        )
        R = np.eye(3) + s * K + (1 - c) * (K @ K)
        out = xyz.copy()
        out[ds] = (xyz[ds] - xyz[j]) @ R.T + xyz[j]
        return out

    def sample_frame() -> np.ndarray:
        if not torsion_diversity:
            return base + rng.normal(scale=jitter, size=base.shape)
        return _grow_frame()[0]

    def _grow_frame():
        """Greedy self-avoiding growth: torsions are set in chain order; at
        each bond the finalized segment (atoms whose relative geometry no
        later torsion can change) is clash-checked against earlier atoms and
        the first non-clashing basin (random order, trans-biased) wins.
        Returns (jittered xyz, applied torsion angles)."""
        xyz = base.copy()
        theta = np.zeros(len(rotatable))
        all_atoms = np.arange(n_atoms)
        for k, ((i, j), ds) in enumerate(zip(rotatable, downstream)):
            nxt = downstream[k + 1] if k + 1 < len(downstream) else []
            final = np.setdiff1d(all_atoms, nxt)  # finalized after this bond
            new = np.intersect1d(ds, final)  # just-finalized segment
            order = rng.choice(3, size=3, replace=False, p=basin_p)
            best, best_clash, best_angle = None, np.inf, 0.0
            for b in order:
                angle = basins[b] + rng.normal() * basin_width
                cand = _rotate(xyz, i, j, ds, angle)
                d = np.linalg.norm(
                    cand[new][:, None, :] - cand[final][None, :, :], axis=-1
                )
                n_clash = int((d < clash_cut[np.ix_(new, final)]).sum())
                if n_clash == 0:
                    best, best_angle = cand, angle
                    break
                if n_clash < best_clash:
                    best, best_clash, best_angle = cand, n_clash, angle
            xyz = best
            theta[k] = best_angle
        return xyz + rng.normal(scale=jitter, size=xyz.shape), theta

    def _build_batch(thetas: np.ndarray) -> np.ndarray:
        """Rebuild conformations from base by applying the torsions in
        chain order (the parameterization _grow_frame records), vectorized
        over frames: one Rodrigues rotation per bond for ALL frames."""
        nf = thetas.shape[0]
        xyz = np.broadcast_to(base, (nf,) + base.shape).copy()
        eye = np.eye(3)
        for k, ((i, j), ds) in enumerate(zip(rotatable, downstream)):
            axis = xyz[:, j] - xyz[:, i]
            axis = axis / np.linalg.norm(axis, axis=-1, keepdims=True)
            a1, a2, a3 = axis[:, 0], axis[:, 1], axis[:, 2]
            zero = np.zeros_like(a1)
            K = np.stack([
                np.stack([zero, -a3, a2], -1),
                np.stack([a3, zero, -a1], -1),
                np.stack([-a2, a1, zero], -1),
            ], axis=1)                                     # (F, 3, 3)
            c = np.cos(thetas[:, k])[:, None, None]
            s = np.sin(thetas[:, k])[:, None, None]
            R = eye[None] + s * K + (1 - c) * (K @ K)
            rel = xyz[:, ds] - xyz[:, j, None]
            xyz[:, ds] = np.einsum("fnd,fed->fne", rel, R) + xyz[:, j, None]
        return xyz

    frames = np.empty((n_frames, n_atoms, 3), dtype=np.float64)
    if torsion_diversity and traj_mode == "md" and len(rotatable):
        # temporally-correlated trajectory: torsion diffusion + occasional
        # basin hops (module docstring). Hops are NOT clash-gated -- the
        # relax + nearest-clean-neighbor repair below restores physical
        # validity, so a hop into a clash simply shortens that excursion.
        sigma_step = np.deg2rad(6.0)
        # hop rate scales inversely with the downstream arm a bond swings:
        # terminal torsions flip often, core torsions rarely (as in a real
        # folded chain) -- also bounds the per-frame cartesian excursion
        ou_kappa = float(_PRESETS[name].get("ou_kappa", 0.0))
        hop_scale = float(_PRESETS[name].get("hop_scale", 1.0))
        p_hop = np.array([min(0.06, 0.24 / max(len(ds), 1))
                          for ds in downstream]) * hop_scale
        _, theta = _grow_frame()
        theta_ref = theta  # folded-state reference torsions (OU mean)
        nrot = len(rotatable)
        thetas = np.empty((n_frames, nrot))
        for f in range(n_frames):
            theta = (theta + ou_kappa * (theta_ref - theta)
                     + rng.normal(scale=sigma_step, size=nrot))
            hops = np.flatnonzero(rng.random(nrot) < p_hop)
            if hops.size:
                theta = theta.copy()
                theta[hops] = (
                    basins[rng.integers(3, size=hops.size)]
                    + rng.normal(size=hops.size) * basin_width
                )
            thetas[f] = theta
        frames[:] = _build_batch(thetas)
        frames += rng.normal(scale=jitter, size=frames.shape)
    else:
        for f in range(n_frames):
            frames[f] = sample_frame()
    frames = relax_frames(z, frames, bonds, rest, margin=relax_margin,
                          device=device)

    # repair-and-relax the stragglers the descent could not untangle; in
    # "md" mode bad frames copy their nearest clean neighbor (+ jitter) so
    # temporal correlation survives, in "iid" mode they resample fresh
    for _ in range(4):
        bad = np.flatnonzero(graph_violations(z, frames, bonds, band=1.02))
        if bad.size == 0:
            break
        good = np.setdiff1d(np.arange(n_frames), bad)
        for f in bad:
            if traj_mode == "md" and good.size:
                g = good[np.argmin(np.abs(good - f))]
                frames[f] = frames[g] + rng.normal(scale=jitter,
                                                   size=base.shape)
            else:
                frames[f] = sample_frame()
        frames[bad] = relax_frames(z, frames[bad], bonds, rest,
                                   margin=relax_margin, device=device)
    else:
        bad = np.flatnonzero(graph_violations(z, frames, bonds, band=1.02))
        if bad.size:
            # leave the frames as-generated (changing them would break
            # cache/A/B reproducibility) but make the escape visible: such
            # frames carry off-distribution geometry that can dominate
            # mean-RMSD metrics (the dipeptide fold-4 frame-901 outlier,
            # examples/results/dipeptide_5fold/README.md)
            import warnings

            warnings.warn(
                f"synthetic_peptide({name!r}): {bad.size}/{n_frames} frames "
                f"still violate the bonded topology after 4 repair rounds "
                f"(first: {bad[:8].tolist()})", RuntimeWarning,
            )

    frames = frames.astype(np.float32)
    frames -= frames.mean(axis=1, keepdims=True)
    return z, frames, bonds


_SIDECHAIN_TEMPLATES: dict = {}


def _sidechain_template(aa: str) -> np.ndarray:
    """Deterministic per-residue-type sidechain offsets (slots 4..13) in
    the local backbone frame (fwd, side, up) -- the synthetic analogue of a
    canonical rotamer. Fixed across all proteins/seeds, so the mapping
    (residue type, backbone frame) -> sidechain atoms is LEARNABLE, as it
    is for real rotamer-dominated structures; per-structure thermal noise
    is added by the caller."""
    if aa in _SIDECHAIN_TEMPLATES:
        return _SIDECHAIN_TEMPLATES[aa]
    from coarsegrainingvae_tpu_torch.data.sidechain import ATOM_MAP_14

    # stable across processes (str hash is randomized by PYTHONHASHSEED)
    rng = np.random.default_rng(7919 * (ord(aa) + 13))
    names = ATOM_MAP_14[aa]
    offs = np.zeros((14, 3))
    prev = np.zeros(3)
    grow = np.array([0.0, 1.0, 0.35])
    grow /= np.linalg.norm(grow)
    # real sidechains reach at most ~7 A from the C-alpha (ARG/LYS tips);
    # 1.5 A per-slot steps let 10-slot chains extend to ~15 A, which makes
    # tip placement amplify backbone-frame error far beyond anything the
    # PCN task sees on real proteins. Use bonded-step 1.2 A inside a 7 A
    # rotamer envelope; steps that would leave the envelope or land within
    # 1 A of an earlier slot (spurious covalent contacts in the
    # coordinate-derived bond graph) are re-drawn.
    max_extent = 7.0
    placed = [np.zeros(3)]  # the C-alpha itself
    for slot in range(4, 14):
        if not names[slot]:
            break
        cand, g2, best_score = None, grow, -np.inf
        for _ in range(20):
            g = grow + 0.45 * rng.normal(size=3)
            g /= np.linalg.norm(g)
            c = prev + 1.2 * g
            near = min(np.linalg.norm(c - p) for p in placed)
            if np.linalg.norm(c) <= max_extent and near >= 1.0:
                cand, g2 = c, g
                break
            # keep the least-bad candidate: prefer separated, in-envelope
            score = min(near, 1.0) - max(np.linalg.norm(c) - max_extent, 0.0)
            if score > best_score:
                best_score, cand, g2 = score, c, g
        prev, grow = cand, g2
        offs[slot] = prev
        placed.append(prev)
    _SIDECHAIN_TEMPLATES[aa] = offs
    return offs


def synthetic_protein(
    n_res: int, seed: int = 0, missing_frac: float = 0.0,
    noise: float = 0.06, well_posed: bool = False,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[str, np.ndarray]:
    """Random protein in the atom14 layout for testing the PCN path without
    SidechainNet: (seq, crd (n_res, 14, 3)).

    The backbone follows a smooth random-walk C-alpha trace (3.8 A spacing);
    backbone atoms sit at ideal offsets in the local chain frame and
    sidechains follow DETERMINISTIC per-residue-type templates
    (_sidechain_template) plus `noise` A of thermal jitter -- like real
    rotamer-dominated structures, the all-atom geometry is a learnable
    function of (sequence, C-alpha trace), which is exactly the PCN task
    (run_pdb.py of the original code). missing_frac randomly zeroes sidechain atoms
    (SidechainNet items have missing coordinates; zero rows = 'absent').

    well_posed=True additionally relaxes the structure (relax_frames)
    against its INTENDED covalent topology (backbone chain + linear
    sidechain chains + peptide bonds) so the coordinate-derived
    covalent-cutoff bond graph (bond_graph_from_coords, same rule as the
    original code's truth graphs at sidechain.py:148-156) equals that topology
    exactly -- a tree. The raw generator leaves template atom pairs and
    O(i)..N(i+1) backbone pairs inside covalent cutoffs, which makes ~40%
    of truth graphs cyclic and exact bond-graph recovery (GED 0) literally
    impossible for any model. Default False preserves the round-3/4 PCN
    A/B data bit-exactly.

    The default path is numpy and gives the JAX package's bits. With
    well_posed the relaxation runs in torch on ``device`` (the card unless
    the caller passes ``"cpu"``), with the physics of the JAX package's
    jitted relaxer.
    """
    from coarsegrainingvae_tpu_torch.data.sidechain import ATOM_MAP_14, AMINO_ACIDS

    rng = np.random.default_rng(seed)
    seq = "".join(rng.choice(list(AMINO_ACIDS), size=n_res))

    # smooth C-alpha random walk, offset from the origin (a zero coordinate
    # row means 'missing atom' in the atom14 convention)
    ca = np.full((n_res, 3), 10.0)
    d = np.array([1.0, 0.0, 0.0])
    for i in range(1, n_res):
        d = d + 0.5 * rng.normal(size=3)
        d /= np.linalg.norm(d)
        ca[i] = ca[i - 1] + 3.8 * d

    crd = np.zeros((n_res, 14, 3), np.float32)
    for i, aa in enumerate(seq):
        names = ATOM_MAP_14[aa]
        # backbone frame from LOCAL chain geometry only (tangent +
        # curvature) -- rotation-covariant, so the all-atom placement is a
        # function an SE(3)-equivariant model can actually learn (a frame
        # anchored to a global axis would make the generative rule
        # non-equivariant and the task unlearnable by construction)
        lo, hi = max(i - 1, 0), min(i + 1, n_res - 1)
        fwd = ca[hi] - ca[lo]
        fwd /= np.linalg.norm(fwd) + 1e-9
        if 0 < i < n_res - 1:
            curv = ca[i + 1] - 2.0 * ca[i] + ca[i - 1]
        elif n_res > 2:
            j = 1 if i == 0 else n_res - 2
            curv = ca[j + 1] - 2.0 * ca[j] + ca[j - 1]
        else:
            curv = np.array([0.0, 1.0, 0.0])
        side = curv - np.dot(curv, fwd) * fwd
        nrm = np.linalg.norm(side)
        if nrm < 1e-6:  # locally straight chain: any stable perpendicular
            side = np.cross(fwd, [0.0, 1.0, 0.0])
            nrm = np.linalg.norm(side)
        side /= nrm
        upv = np.cross(fwd, side)
        frame = np.stack([fwd, side, upv])                    # (3, 3)
        crd[i, 1] = ca[i]
        crd[i, 0] = ca[i] - 1.46 * fwd + 0.2 * upv            # N
        crd[i, 2] = ca[i] + 1.52 * fwd + 0.2 * upv            # C
        crd[i, 3] = crd[i, 2] + 1.23 * upv                    # O
        offs = _sidechain_template(aa)
        for slot in range(4, 14):
            if not names[slot]:
                break
            crd[i, slot] = ca[i] + offs[slot] @ frame
        present = np.array([bool(nm) for nm in names])
        crd[i, present] += noise * rng.normal(size=(int(present.sum()), 3))
        if missing_frac > 0 and not well_posed:
            for slot in range(4, 14):
                if names[slot] and rng.random() < missing_frac:
                    crd[i, slot] = 0.0
    if well_posed:
        crd = _relax_protein_atom14(seq, crd, device)
        if missing_frac > 0:  # zero AFTER relaxing (zero rows = absent)
            for i, aa in enumerate(seq):
                names = ATOM_MAP_14[aa]
                for slot in range(4, 14):
                    if names[slot] and rng.random() < missing_frac:
                        crd[i, slot] = 0.0
    return seq, crd


# element -> atomic number for atom14 atom-name first characters
_NAME2Z = {"N": 7, "C": 6, "O": 8, "S": 16}


def intended_atom14_bonds(seq: str) -> "list[tuple[int, int, int, int]]":
    """Covalent topology the synthetic generator MEANS to draw, as
    ((res_i, slot_i), (res_j, slot_j)) pairs flattened to 4-tuples:
    backbone N-CA-C(-O), CA-CB, linear sidechain slot chains, and the
    peptide C(i)-N(i+1) links."""
    from coarsegrainingvae_tpu_torch.data.sidechain import ATOM_MAP_14

    out = []
    for i, aa in enumerate(seq):
        names = ATOM_MAP_14[aa]
        out += [(i, 0, i, 1), (i, 1, i, 2), (i, 2, i, 3)]
        prev_slot = 1  # sidechain chain grows off the C-alpha
        for slot in range(4, 14):
            if not names[slot]:
                break
            out.append((i, prev_slot, i, slot))
            prev_slot = slot
        if i + 1 < len(seq):
            out.append((i, 2, i + 1, 0))  # peptide bond
    return out



def _relax_atom14(x: torch.Tensor, radii: torch.Tensor, bi: torch.Tensor, bj: torch.Tensor,
                  rest: torch.Tensor, margin: float, n_iter: int = 300) -> torch.Tensor:
    """One structure's relaxation, the physics of ``relax_frames``' inner
    loop (the JAX package's ``_relax_atom14_impl``): a soft-sphere push on
    nonbonded pairs inside margin * 1.3 * (r_i + r_j) and a spring to the
    rest length on every bond, by steepest descent with a decaying step.
    The bond forces go into their atoms through ``segment_sum`` over the
    endpoints in a fixed order, so the card gives the same bits on every
    call."""
    n = radii.shape[0]
    thr = 1.3 * margin * (radii[:, None] + radii[None, :])
    thr[bi, bj] = 0.0
    thr[bj, bi] = 0.0
    thr.fill_diagonal_(0.0)
    eye = torch.eye(n, dtype=torch.float32, device=x.device)
    ends = torch.cat([bi, bj])
    order = torch.argsort(ends, stable=True)
    ends = ends[order]
    for it in range(n_iter):
        diff = x[:, None, :] - x[None, :, :]
        d = torch.sqrt((diff**2).sum(-1) + eye)
        nb_viol = torch.clamp(thr - d, min=0.0)
        force = ((nb_viol / d)[..., None] * diff).sum(1)
        dbond = d[bi, bj]
        fb = ((dbond - rest) / dbond)[..., None] * diff[bi, bj]
        force = force + segment_sum(torch.cat([-fb, fb])[order], ends, n,
                                    indices_are_sorted=True)
        # the step schedule in float32, as the jitted JAX loop evaluates it
        lr = float(np.float32(0.2) / (np.float32(1.0) + np.float32(0.02) * np.float32(it)))
        x = x + lr * force
    return x


def _relax_protein_atom14(seq: str, crd: np.ndarray,
                          device: Union[str, torch.device] = "cuda") -> np.ndarray:
    """Relax an atom14 structure on ``device`` so its covalent-cutoff bond
    graph equals intended_atom14_bonds(seq) exactly (see
    synthetic_protein.well_posed): the present slots flattened, rounds of
    ``_relax_atom14`` from a fresh step schedule until the graph of the
    float32 coordinates (as the dataset stores them) is the intended one,
    at most 8, then the coordinates scattered back into (n_res, 14, 3).
    The JAX package pads the atoms and bonds to multiples of 256 to bound
    its compilations; far-away dummy atoms and self-loop bonds exert no
    force, so the port relaxes the real atoms alone."""
    from coarsegrainingvae_tpu_torch.data.sidechain import (
        _COV_RADII,
        ATOM_MAP_14,
        bond_graph_from_coords,
    )

    device = torch.device(device)
    flat_idx = -np.ones((len(seq), 14), np.int64)
    z_list, xyz_list = [], []
    for i, aa in enumerate(seq):
        for slot, nm in enumerate(ATOM_MAP_14[aa]):
            if nm:
                flat_idx[i, slot] = len(z_list)
                z_list.append(_NAME2Z[nm[0]])
                xyz_list.append(crd[i, slot])
    z = np.asarray(z_list, np.int64)
    xyz = np.asarray(xyz_list, np.float64)
    bonds = np.array([(flat_idx[ri, si], flat_idx[rj, sj])
                      for ri, si, rj, sj in intended_atom14_bonds(seq)], np.int64)
    d0 = np.linalg.norm(xyz[bonds[:, 0]] - xyz[bonds[:, 1]], axis=-1)
    rest = np.clip(d0, 1.25, 1.6)  # peptide C-N starts ~0.8: pull to bond range
    # the truth graphs PCN is scored against come from sidechain._COV_RADII
    # (bond_graph_from_coords), whose C/N/O/S radii are larger than the
    # metrics' covalent table: relax against the larger one to clear both
    radii = torch.tensor([_COV_RADII[int(s)] for s in z], dtype=torch.float32, device=device)
    bi = torch.as_tensor(bonds[:, 0], device=device)
    bj = torch.as_tensor(bonds[:, 1], device=device)
    rest_t = torch.as_tensor(rest, dtype=torch.float32, device=device)

    want = {tuple(sorted(map(int, e))) for e in bonds}
    x = torch.as_tensor(xyz, dtype=torch.float32, device=device)
    for _round in range(8):  # a fresh step schedule each round
        x = _relax_atom14(x, radii, bi, bj, rest_t, 1.12)
        relaxed = x.cpu().numpy().astype(np.float64)
        got = {tuple(sorted(map(int, e)))
               for e in bond_graph_from_coords(z, relaxed.astype(np.float32))}
        if got == want:
            break
    else:
        import warnings

        warnings.warn(f"atom14 relax left a cyclic truth graph at n_res={len(seq)}",
                      stacklevel=2)
    out = crd.copy()
    present = flat_idx >= 0
    out[present] = relaxed[flat_idx[present]]
    return out
