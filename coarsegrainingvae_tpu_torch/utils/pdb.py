"""Minimal PDB writer and parser for the protein path (port of
``coarsegrainingvae_tpu.utils.pdb``).

The writer stands in for the original code's PdbBuilder (pdbutils.py:11-234):
SEQRES and ATOM records from a one-letter sequence and per-atom coordinates
in the atom14 slot convention (``data/sidechain.py``). The parser covers
the CASP14 ingestion (get_CASP14_targets, sidechain.py:334-396), which
the original code runs through mdtraj: the fixed-column ATOM records are
read straight into the (L, 14, 3) atom14 layout that feeds
``protein_props`` and ``build_pcn_dataset``. The same structure gives the
JAX package's file byte for byte.
"""
from __future__ import annotations

import glob
import os
import warnings
from typing import List, Optional, Sequence, Tuple

import numpy as np

from coarsegrainingvae_tpu_torch.data.sidechain import (
    ATOM_MAP_14,
    NUM_COORDS_PER_RES,
    ONE_TO_THREE,
    THREE_LETTER_TO_ONE,
)


def format_atom_line(
    serial: int,
    name: str,
    res_name: str,
    chain: str,
    res_seq: int,
    xyz: Sequence[float],
    element: str,
    occupancy: float = 1.0,
    b_factor: float = 0.0,
) -> str:
    """One fixed-column ATOM record."""
    # atom names shorter than 4 chars start at column 14
    name_field = f" {name:<3s}" if len(name) < 4 else f"{name:<4s}"
    return (
        f"ATOM  {serial:5d} {name_field}{'':1s}{res_name:>3s} {chain:1s}"
        f"{res_seq:4d}{'':4s}{xyz[0]:8.3f}{xyz[1]:8.3f}{xyz[2]:8.3f}"
        f"{occupancy:6.2f}{b_factor:6.2f}{'':10s}{element:>2s}"
    )


def write_pdb(
    path: str,
    seq: str,
    xyz: np.ndarray,
    mapping: np.ndarray,
    channel_idx: np.ndarray,
    atom_mask: Optional[np.ndarray] = None,
    chain: str = "A",
    title: str = "coarsegrainingvae_tpu reconstruction",
) -> None:
    """Dump a backmapped structure (save_pdb / PdbBuilder equivalents,
    sidechain.py:170-185, pdbutils.py:11-234).

    xyz (n, 3) flat atoms; mapping (n,) residue index; channel_idx (n,)
    atom14 slot of each atom. The default title is the JAX package's, so
    both write the same bytes.
    """
    xyz = np.asarray(xyz, np.float64)
    lines = [f"TITLE     {title}"]

    # SEQRES records, 13 residues per line
    three = [ONE_TO_THREE[a] for a in seq]
    for i in range(0, len(three), 13):
        row = three[i : i + 13]
        lines.append(
            f"SEQRES {i // 13 + 1:3d} {chain:1s} {len(seq):4d}  " + " ".join(row)
        )

    serial = 1
    for ai in range(xyz.shape[0]):
        if atom_mask is not None and not atom_mask[ai]:
            continue
        res = int(mapping[ai])
        aa = seq[res]
        name = ATOM_MAP_14[aa][int(channel_idx[ai])]
        if not name:
            continue
        lines.append(
            format_atom_line(
                serial, name, ONE_TO_THREE[aa], chain, res + 1, xyz[ai], name[0]
            )
        )
        serial += 1
    lines.append("TER")
    lines.append("END")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


# non-standard residues commonly found in experimental structures that map
# cleanly onto a standard parent (selenomethionine etc.)
_RES_ALIASES = {"MSE": "M", "SEC": "C", "PYL": "K"}


def parse_pdb(path: str) -> Tuple[str, np.ndarray]:
    """Parse ATOM records of a PDB file into (seq, crd (L, 14, 3)).

    The inverse of write_pdb and the ingestion path for CASP14-style target
    files (sidechain.py:334-396 of the original code, via mdtraj). Rules:
    model 1 only (stops at ENDMDL); first alternate location only
    (altLoc blank or 'A'); hydrogens and atoms outside the atom14 layout
    (e.g. OXT) are skipped; residues with no standard one-letter code are
    skipped with a warning. Missing atoms are zero rows (the SidechainNet
    'absent' convention, data/sidechain.py).
    """
    seq_letters: List[str] = []
    coords: List[np.ndarray] = []
    cur_key = None
    skipped: set = set()

    with open(path) as f:
        for line in f:
            rec = line[:6]
            if rec == "ENDMDL":
                break
            if rec != "ATOM  ":
                continue
            altloc = line[16]
            if altloc not in (" ", "A"):
                continue
            name = line[12:16].strip()
            res_name = line[17:20].strip()
            aa = THREE_LETTER_TO_ONE.get(res_name) or _RES_ALIASES.get(res_name)
            key = (line[21], line[22:26], line[26])  # chain, resSeq, iCode
            if aa is None:
                skipped.add(res_name)
                cur_key = key  # consume the residue's remaining atoms too
                continue
            if key != cur_key:
                cur_key = key
                seq_letters.append(aa)
                coords.append(np.zeros((NUM_COORDS_PER_RES, 3), np.float32))
            names = ATOM_MAP_14[aa]
            if name not in names:
                continue  # hydrogen, OXT, or other off-layout atom
            slot = names.index(name)
            coords[-1][slot] = [
                float(line[30:38]), float(line[38:46]), float(line[46:54])
            ]

    if skipped:
        warnings.warn(
            f"parse_pdb({os.path.basename(path)}): skipped non-standard "
            f"residues {sorted(skipped)}"
        )
    if not seq_letters:
        raise ValueError(f"no parseable ATOM records in {path}")
    return "".join(seq_letters), np.stack(coords)


def load_pdb_dir(path: str) -> List[Tuple[str, str, np.ndarray]]:
    """All *.pdb files under a directory -> [(id, seq, crd)], sorted by id
    (the original code globs its CASP14 target directory the same way,
    sidechain.py:342)."""
    out = []
    for file in sorted(glob.glob(os.path.join(path, "*.pdb"))):
        pdb_id = os.path.splitext(os.path.basename(file))[0]
        seq, crd = parse_pdb(file)
        out.append((pdb_id, seq, crd))
    if not out:
        raise FileNotFoundError(f"no .pdb files under {path}")
    return out
