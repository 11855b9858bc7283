"""Precompute packed dataset caches (port of
``coarsegrainingvae_tpu.cli.generate_cache``; scripts/generate_pkl.py:12-44
of the original code, which pre-parses SidechainNet pickles). Host numpy;
it writes the JAX package's files.

  * protein:  a pickle of {'seq': [...], 'crd': [...]} or a directory of
              .pdb files (CASP14-style targets, parsed by utils/pdb.py)
              -> padded PCN arrays saved as npz
  * traj:     a (z, xyz, bonds) npz, validated and re-compressed
  * pdbtraj:  a directory of same-topology per-frame .pdb files -> the
              trajectory npz (data/proteins.py::traj_npz_from_pdb_frames)
  * mdtraj:   any trajectory mdtraj can read (-src glob, -top topology pdb)
              -> the trajectory npz; mdtraj is imported only here

Usage:
    python -m coarsegrainingvae_tpu_torch.cli.generate_cache -kind protein \
        -src casp14_targets/ -out casp14_cache.npz
    python -m coarsegrainingvae_tpu_torch.cli.generate_cache -kind pdbtraj \
        -src frames_dir/ -out dipeptide.npz
"""
from __future__ import annotations

import argparse
import os
import pickle

import numpy as np


def cache_proteins(src: str, out: str, cutoff: float = 10.0) -> None:
    from coarsegrainingvae_tpu_torch.data.sidechain import build_pcn_dataset

    if os.path.isdir(src):
        from coarsegrainingvae_tpu_torch.utils.pdb import load_pdb_dir

        items = [(seq, crd) for _, seq, crd in load_pdb_dir(src)]
    else:
        with open(src, "rb") as f:
            d = pickle.load(f)
        items = list(zip(d["seq"], d["crd"]))
    ds = build_pcn_dataset(items, cg_cutoff=cutoff)
    arrays = {
        k: getattr(ds, k)
        for k in ("z", "xyz", "atom_mask", "res_idx", "ca_xyz", "cg_mask",
                  "mapping", "channel_idx", "ca_flag", "nbrs", "nbr_mask",
                  "bonds", "bond_mask", "dihe_quads", "dihe_mask")
    }
    np.savez_compressed(out, seqs=np.array(ds.seqs), **arrays)
    print(f"wrote {out}: {len(ds)} proteins, n_max={ds.z.shape[1]}")


def cache_traj(src: str, out: str) -> None:
    from coarsegrainingvae_tpu_torch.data.proteins import load_npz_traj, save_npz_traj

    z, xyz, bonds = load_npz_traj(src)
    save_npz_traj(out, z, xyz, bonds)
    print(f"wrote {out}: {xyz.shape[0]} frames x {xyz.shape[1]} atoms")


def cache_pdbtraj(src: str, out: str) -> None:
    from coarsegrainingvae_tpu_torch.data.proteins import traj_npz_from_pdb_frames

    z, xyz, bonds = traj_npz_from_pdb_frames(src, out_path=out)
    print(f"wrote {out}: {xyz.shape[0]} frames x {z.shape[0]} atoms, "
          f"{bonds.shape[0]} bonds")


def cache_mdtraj(src: str, top: str, out: str, ndata: int = 0) -> None:
    """The original code's ingestion (datasets.py:170-187): glob trajectory
    files, md.load each against the topology, join, slice protein atoms,
    nm -> Angstrom. Run on an mdtraj-equipped machine; the npz is portable."""
    import glob as _glob

    import mdtraj as md  # gated: clear ImportError where unavailable

    from coarsegrainingvae_tpu_torch.data.proteins import ATOMIC_NUM, save_npz_traj

    files = sorted(_glob.glob(src))[:200]  # the original code caps at 200 files
    if not files:
        raise FileNotFoundError(f"no trajectory files match {src!r}")
    traj = md.join([md.load(f, top=top) for f in files])
    traj = traj.atom_slice(traj.top.select("protein"))
    z = np.array([ATOMIC_NUM[a.element.symbol] for a in traj.top.atoms],
                 np.int32)
    xyz = (traj.xyz if not ndata else traj.xyz[:ndata]) * 10.0
    bonds = np.array([[b[0].index, b[1].index] for b in traj.top.bonds],
                     np.int32)
    names = np.array([a.name for a in traj.top.atoms])
    np.savez_compressed(out, z=z, xyz=xyz.astype(np.float32), bonds=bonds,
                        atom_names=names)
    print(f"wrote {out}: {xyz.shape[0]} frames x {z.shape[0]} atoms")


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-kind", choices=["protein", "traj", "pdbtraj", "mdtraj"],
                   required=True)
    p.add_argument("-src", required=True)
    p.add_argument("-out", required=True)
    p.add_argument("-cutoff", type=float, default=10.0)
    p.add_argument("-top", default="", help="topology pdb (mdtraj kind)")
    p.add_argument("-ndata", type=int, default=0)
    a = p.parse_args(argv)
    if a.kind == "protein":
        cache_proteins(a.src, a.out, a.cutoff)
    elif a.kind == "pdbtraj":
        cache_pdbtraj(a.src, a.out)
    elif a.kind == "mdtraj":
        cache_mdtraj(a.src, a.top, a.out, a.ndata)
    else:
        cache_traj(a.src, a.out)


if __name__ == "__main__":
    main()
