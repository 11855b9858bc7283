"""Trajectory loading: dataset registry, npz cache and the gated MD-library
path (port of ``coarsegrainingvae_tpu.data.proteins``).

The registry PROTEINFILES (datasets.py:24-40 of the original code) points at
DESRES/mdshare trajectory files loaded through mdtraj. Loading resolves in
order:

1. a packed ``.npz`` cache (``{name}.npz`` with z/xyz/bonds arrays) under
   ``COARSEGRAININGVAE_DATA`` or ``./data``;
2. mdtraj, if importable, for the registry's raw trajectory formats;
3. the synthetic stand-in ensembles (``data/synthetic.py``), cached under
   the same key as the JAX package's.

``traj_npz_from_pdb_frames`` writes that npz from a directory of per-frame
PDB files, without mdtraj.
"""
from __future__ import annotations

import glob
import os
import tempfile
from typing import Optional, Tuple, Union

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.synthetic import SYNTH_VERSION, synthetic_peptide

# name -> (traj glob, topology file); mirrors PROTEINFILES (datasets.py:24-40)
PROTEINFILES = {
    "covid": {"traj_paths": "DESRES-Trajectory_spike/*.dcd",
              "pdb_path": "DESRES_spike.pdb"},
    "chignolin": {"traj_paths": "filtered/*.xtc",
                  "pdb_path": "filtered/filtered.pdb"},
    "dipeptide": {"traj_paths": "alanine-dipeptide-*-250ns-nowater.xtc",
                  "pdb_path": "alanine-dipeptide-nowater.pdb"},
    "pentapeptide": {"traj_paths": "pentapeptide-*-500ns-impl-solv.xtc",
                     "pdb_path": "pentapeptide-impl-solv.pdb"},
}

ATOMIC_NUM = {"H": 1, "C": 6, "N": 7, "O": 8, "S": 16}  # datasets.py:22


def data_root() -> str:
    return os.environ.get("COARSEGRAININGVAE_DATA", "./data")


def save_npz_traj(path: str, z: np.ndarray, xyz: np.ndarray, bonds: np.ndarray) -> None:
    np.savez_compressed(path, z=z.astype(np.int32), xyz=xyz.astype(np.float32),
                        bonds=bonds.astype(np.int32))


def load_npz_traj(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    with np.load(path) as f:
        return f["z"], f["xyz"], f["bonds"]


def _load_mdtraj(name: str, ndata: int):
    """Raw trajectory path via mdtraj (load_protein_traj,
    datasets.py:170-187). Returns None when mdtraj is unavailable."""
    try:
        import mdtraj as md
    except ImportError:
        return None
    entry = PROTEINFILES.get(name)
    if entry is None:
        return None
    root = data_root()
    files = sorted(glob.glob(os.path.join(root, entry["traj_paths"])))[:200]
    top = os.path.join(root, entry["pdb_path"])
    if not files or not os.path.exists(top):
        return None
    traj = md.join([md.load(f, top=top) for f in files])
    traj = traj.atom_slice(traj.top.select("protein"))
    z = np.array([ATOMIC_NUM[a.element.symbol] for a in traj.top.atoms], np.int32)
    xyz = traj.xyz[:ndata] * 10.0  # nm -> Angstrom (datasets.py:436)
    bonds = np.array([[b[0].index, b[1].index] for b in traj.top.bonds], np.int32)
    return z, xyz.astype(np.float32), bonds


def load_frames(
    name: str, ndata: int, seed: int = 123, shuffle: bool = True,
    device: Union[str, torch.device] = "cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(z, frames (ndata, N, 3), bonds). Resolution order: npz cache ->
    mdtraj -> synthetic stand-in (module docstring). ``device`` is where the
    synthetic frames are relaxed (the card unless the caller passes
    ``"cpu"``); the other two branches do not read it."""
    cache = os.path.join(data_root(), f"{name}.npz")
    if os.path.exists(cache):
        z, xyz, bonds = load_npz_traj(cache)
    else:
        loaded = _load_mdtraj(name, max(ndata * 2, ndata))
        if loaded is not None:
            z, xyz, bonds = loaded
        else:
            # synthetic generation relaxes every frame against covalent
            # cutoffs -- cache per (generator version, name, ndata, seed) so
            # repeat runs skip it and generator changes invalidate
            cdir = os.path.join(tempfile.gettempdir(), "cgvae_synth_cache")
            cpath = os.path.join(cdir, f"v{SYNTH_VERSION}_{name}_{ndata}_{seed}.npz")
            if os.path.exists(cpath):
                with np.load(cpath) as d:
                    z, xyz, bonds = d["z"], d["xyz"], d["bonds"]
            else:
                z, xyz, bonds = synthetic_peptide(name, n_frames=ndata, seed=seed,
                                                  device=device)
                os.makedirs(cdir, exist_ok=True)
                tmp = cpath + ".tmp.npz"
                np.savez_compressed(tmp, z=z, xyz=xyz, bonds=bonds)
                os.replace(tmp, cpath)

    if shuffle:
        # shuffle_traj (scripts/utils.py:17-20)
        order = np.random.default_rng(seed).permutation(xyz.shape[0])
        xyz = xyz[order]
    return z, xyz[:ndata], bonds


def traj_npz_from_pdb_frames(
    pdb_dir: str, out_path: Optional[str] = None, bond_scale: float = 1.3
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Directory of same-topology PDB frames -> (z, xyz (S, n, 3), bonds),
    optionally saved as the native trajectory npz cache.

    The mdtraj-free leg of the real-data ingestion (datasets.py:170-187 of
    the original code loads xtc/dcd through mdtraj): dump an MD trajectory
    to per-frame PDB files, convert here, and load_frames picks the npz up.
    Every frame must share the first frame's sequence and set of resolved
    atoms; the bond graph comes from covalent-radius cutoffs on the first
    frame (sidechain.py:148-156), and the npz also carries per-atom names
    so minimal/alpha site selection can use them.
    """
    from coarsegrainingvae_tpu_torch.data.sidechain import protein_props
    from coarsegrainingvae_tpu_torch.utils.pdb import load_pdb_dir

    frames = load_pdb_dir(pdb_dir)
    ref_id, ref_seq, ref_crd = frames[0]
    ref = protein_props(ref_seq, ref_crd)
    xyz_list = [ref.xyz]
    for pdb_id, seq, crd in frames[1:]:
        if seq != ref_seq:
            raise ValueError(
                f"{pdb_id}: sequence differs from {ref_id}; trajectory "
                "frames must share one topology"
            )
        p = protein_props(seq, crd)
        if p.z.shape != ref.z.shape or not np.array_equal(
            p.channel_idx, ref.channel_idx
        ):
            raise ValueError(
                f"{pdb_id}: resolved-atom set differs from {ref_id}"
            )
        xyz_list.append(p.xyz)
    xyz = np.stack(xyz_list)
    if out_path is not None:
        from coarsegrainingvae_tpu_torch.data.sidechain import ATOM_NAMES

        names = np.array([ATOM_NAMES[i] for i in ref.atom_idx])
        np.savez_compressed(
            out_path, z=ref.z.astype(np.int32), xyz=xyz.astype(np.float32),
            bonds=ref.bonds.astype(np.int32), atom_names=names,
        )
    return ref.z, xyz, ref.bonds


def load_traj_atom_names(name: str):
    """Per-atom names from a trajectory npz cache, when present; None
    otherwise. Lets minimal/alpha site selection use the exact reference
    selections instead of the bond-graph derivation."""
    cache = os.path.join(data_root(), f"{name}.npz")
    if not os.path.exists(cache):
        return None
    with np.load(cache) as f:
        if "atom_names" not in f:
            return None
        return [str(s) for s in f["atom_names"]]
