"""Protein (SidechainNet-style) data for PCN backmapping (port of
``coarsegrainingvae_tpu.data.sidechain``).

The vocabulary tables (sidechain.py:24-145 of the original code), the flat
per-protein props built straight from the (L, 14, 3) atom14 coordinates
(:187-329, without the PDB round trip), the covalent bond graphs
(:148-156), and the padded multi-protein dataset whose ``batch`` gives the
port's ``CGBatch`` on the CPU. The atom14 layout is the standard heavy-atom
convention (backbone N, CA, C, O, then each residue's side-chain atoms in a
fixed order) of SidechainNet and AlphaFold. Host numpy throughout; the
same items give the JAX package's arrays.

``load_sidechainnet`` imports the ``sidechainnet`` package only when asked
for a CASP spec rather than a pickle on disk.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.data.neighbors import make_directed, radius_graph_dense

NUM_COORDS_PER_RES = 14

# structures the original code excludes from SidechainNet ingestion
# (problematic entries; sidechain.py:142-143)
SEQ_BLACKLIST = [
    "MPEFLEDPSVLTKDKLKSELVANNVTLPAGEQRKDVYVQLYLQHLTARNRPPLPAGTNSKGPPDFSSDE"
    "EREPTPVLGSGAAAAGRSRAAVGRKATKKTDKPRQEDKDDLDVTELTNEDLLDQLVKYGVNPGPIVGTT"
    "RKLYEKKLLKLREQGTESRSSTPLPTISSS",
    "MDVKPDRVIDARGSYCPGPLMELIKAYKQAKVGEVISVYSTDAGTKKDAPAWIQKSGQELVGVFDRNGY"
    "YEIVMKKVK",
]

THREE_LETTER_TO_ONE = {
    "ALA": "A", "ARG": "R", "ASN": "N", "ASP": "D", "CYS": "C",
    "GLN": "Q", "GLU": "E", "GLY": "G", "HIS": "H", "ILE": "I",
    "LEU": "L", "LYS": "K", "MET": "M", "PHE": "F", "PRO": "P",
    "SER": "S", "THR": "T", "TRP": "W", "TYR": "Y", "VAL": "V",
}
ONE_TO_THREE = {v: k for k, v in THREE_LETTER_TO_ONE.items()}

# residue-type vocabulary (one-letter, alphabetical -> index; 0 reserved
# for padding like the reference's padding_idx embeddings)
AMINO_ACIDS = "ACDEFGHIKLMNPQRSTVWY"
RES2IDX = {aa: i + 1 for i, aa in enumerate(AMINO_ACIDS)}

# heavy-atom names per residue in atom14 slot order
ATOM_MAP_14 = {
    "A": ["N", "CA", "C", "O", "CB"],
    "R": ["N", "CA", "C", "O", "CB", "CG", "CD", "NE", "CZ", "NH1", "NH2"],
    "N": ["N", "CA", "C", "O", "CB", "CG", "OD1", "ND2"],
    "D": ["N", "CA", "C", "O", "CB", "CG", "OD1", "OD2"],
    "C": ["N", "CA", "C", "O", "CB", "SG"],
    "Q": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "NE2"],
    "E": ["N", "CA", "C", "O", "CB", "CG", "CD", "OE1", "OE2"],
    "G": ["N", "CA", "C", "O"],
    "H": ["N", "CA", "C", "O", "CB", "CG", "ND1", "CD2", "CE1", "NE2"],
    "I": ["N", "CA", "C", "O", "CB", "CG1", "CG2", "CD1"],
    "L": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2"],
    "K": ["N", "CA", "C", "O", "CB", "CG", "CD", "CE", "NZ"],
    "M": ["N", "CA", "C", "O", "CB", "CG", "SD", "CE"],
    "F": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2", "CZ"],
    "P": ["N", "CA", "C", "O", "CB", "CG", "CD"],
    "S": ["N", "CA", "C", "O", "CB", "OG"],
    "T": ["N", "CA", "C", "O", "CB", "OG1", "CG2"],
    "W": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "NE1", "CE2",
          "CE3", "CZ2", "CZ3", "CH2"],
    "Y": ["N", "CA", "C", "O", "CB", "CG", "CD1", "CD2", "CE1", "CE2",
          "CZ", "OH"],
    "V": ["N", "CA", "C", "O", "CB", "CG1", "CG2"],
}
ATOM_MAP_14 = {k: v + [""] * (NUM_COORDS_PER_RES - len(v)) for k, v in ATOM_MAP_14.items()}

# atom-name vocabulary over all residues (reference ATOM2IDX has 36 types)
ATOM_NAMES = sorted({a for names in ATOM_MAP_14.values() for a in names if a})
ATOM2IDX = {a: i for i, a in enumerate(ATOM_NAMES)}

_ELEMENT_Z = {"C": 6, "N": 7, "O": 8, "S": 16}
ATOM2Z = {a: _ELEMENT_Z[a[0]] for a in ATOM_NAMES}


@dataclasses.dataclass
class ProteinProps:
    """One protein, flat over its present heavy atoms."""

    seq: str
    z: np.ndarray            # (n,) atomic numbers
    atom_idx: np.ndarray     # (n,) ATOM2IDX atom-name ids
    xyz: np.ndarray          # (n, 3)
    mapping: np.ndarray      # (n,) residue index of each atom
    channel_idx: np.ndarray  # (n,) atom14 slot index within its residue
    res_idx: np.ndarray      # (L,) RES2IDX residue-type ids
    ca_xyz: np.ndarray       # (L, 3) C-alpha coordinates (the CG trace)
    ca_flag: np.ndarray      # (n,) bool, True at the C-alpha atom
    bonds: np.ndarray        # (Eb, 2) covalent-radius bond graph


# covalent radii for the elements that occur (Angstrom); same table family
# as the reference's COVCUTOFFTABLE (sampling.py:12-118)
_COV_RADII = {6: 0.76, 7: 0.71, 8: 0.66, 16: 1.05}


def bond_graph_from_coords(
    z: np.ndarray, xyz: np.ndarray, scale: float = 1.3
) -> np.ndarray:
    """Bonds = atom pairs closer than scale * (r_i + r_j)
    (reference get_bond_graphs, sidechain.py:148-156). Returns upper-tri
    (Eb, 2) pairs."""
    r = np.array([_COV_RADII[int(v)] for v in z])
    cut = scale * (r[:, None] + r[None, :])
    d = np.linalg.norm(xyz[:, None] - xyz[None, :], axis=-1)
    pairs = np.argwhere((d < cut) & np.triu(np.ones_like(d, dtype=bool), k=1))
    return pairs.astype(np.int32)


def protein_props(seq: str, crd: np.ndarray) -> ProteinProps:
    """SidechainNet item -> flat props (get_sidechainet_props,
    sidechain.py:187-329, minus the PDB round-trip).

    seq: one-letter sequence (length L); crd: (L*14, 3) or (L, 14, 3)
    atom14 coordinates, zero rows = missing atoms.
    """
    crd = np.asarray(crd, np.float32).reshape(len(seq), NUM_COORDS_PER_RES, 3)
    z_list: List[int] = []
    atom_ids: List[int] = []
    xyz: List[np.ndarray] = []
    mapping: List[int] = []
    channel: List[int] = []
    ca_flag: List[bool] = []
    ca_xyz = np.zeros((len(seq), 3), np.float32)

    for li, aa in enumerate(seq):
        names = ATOM_MAP_14[aa]
        ca_xyz[li] = crd[li, 1]
        for slot, name in enumerate(names):
            if not name:
                continue
            if not np.any(crd[li, slot]):
                continue  # missing atom
            z_list.append(ATOM2Z[name])
            atom_ids.append(ATOM2IDX[name])
            xyz.append(crd[li, slot])
            mapping.append(li)
            channel.append(slot)
            ca_flag.append(name == "CA")

    z = np.asarray(z_list, np.int32)
    xyz_arr = np.asarray(xyz, np.float32)
    return ProteinProps(
        seq=seq,
        z=z,
        atom_idx=np.asarray(atom_ids, np.int32),
        xyz=xyz_arr,
        mapping=np.asarray(mapping, np.int32),
        channel_idx=np.asarray(channel, np.int32),
        res_idx=np.asarray([RES2IDX[a] for a in seq], np.int32),
        ca_xyz=ca_xyz,
        ca_flag=np.asarray(ca_flag, bool),
        bonds=bond_graph_from_coords(z, xyz_arr),
    )


def backbone_dihedral_quads(props: ProteinProps) -> np.ndarray:
    """(Q, 4) atom-index quads for phi/psi backbone dihedrals
    (run_pdb.py:87-141 builds these for the dihedral loss).

    phi(i) = C(i-1), N(i), CA(i), C(i);  psi(i) = N(i), CA(i), C(i), N(i+1).
    Uses only residues whose backbone atoms are all present.
    """
    L = len(props.seq)
    # index of backbone slots per residue (-1 if missing)
    bb = -np.ones((L, 3), np.int64)  # N, CA, C
    for ai, (res, slot) in enumerate(zip(props.mapping, props.channel_idx)):
        if slot < 3:
            bb[res, slot] = ai
    quads = []
    for i in range(L):
        if i > 0 and bb[i - 1, 2] >= 0 and np.all(bb[i] >= 0):
            quads.append([bb[i - 1, 2], bb[i, 0], bb[i, 1], bb[i, 2]])
        if i + 1 < L and np.all(bb[i] >= 0) and bb[i + 1, 0] >= 0:
            quads.append([bb[i, 0], bb[i, 1], bb[i, 2], bb[i + 1, 0]])
    return np.asarray(quads, np.int32) if quads else np.zeros((0, 4), np.int32)


@dataclasses.dataclass
class PCNDatasetArrays:
    """Padded multi-protein dataset for PCN training.

    Unlike the single-topology CGDatasetArrays, every sample has its own
    topology; arrays are padded to (n_max atoms, l_max residues, e_max
    edges, q_max dihedral quads) with masks.
    """

    z: np.ndarray            # (S, N) atomic numbers, 0 pad
    xyz: np.ndarray          # (S, N, 3)
    atom_mask: np.ndarray    # (S, N)
    res_idx: np.ndarray      # (S, L) residue types, 0 pad
    ca_xyz: np.ndarray       # (S, L, 3)
    cg_mask: np.ndarray      # (S, L)
    mapping: np.ndarray      # (S, N) residue of atom (pad -> 0)
    channel_idx: np.ndarray  # (S, N)
    ca_flag: np.ndarray      # (S, N)
    nbrs: np.ndarray         # (S, E, 2) radius graph (directed)
    nbr_mask: np.ndarray     # (S, E)
    bonds: np.ndarray        # (S, Eb, 2)
    bond_mask: np.ndarray    # (S, Eb)
    dihe_quads: np.ndarray   # (S, Q, 4)
    dihe_mask: np.ndarray    # (S, Q)
    seqs: List[str]

    def __len__(self) -> int:
        return self.z.shape[0]

    def subset(self, idx: np.ndarray) -> "PCNDatasetArrays":
        return dataclasses.replace(
            self,
            **{
                f.name: getattr(self, f.name)[idx]
                for f in dataclasses.fields(self)
                if f.name != "seqs"
            },
            seqs=[self.seqs[i] for i in idx],
        )

    def batch(self, idx: np.ndarray) -> CGBatch:
        """A CGBatch on the CPU; cg_z carries the residue-type id (PCN
        embeds residue type, cgvae.py:529), and the decoder's CG graph is
        the C-alpha radius graph in nbrs."""
        def ids(a):
            return torch.as_tensor(a[idx], dtype=torch.long)

        def arr(a):
            return torch.as_tensor(a[idx])

        return CGBatch(
            z=ids(self.z),
            xyz=arr(self.xyz),
            atom_mask=arr(self.atom_mask),
            cg_z=ids(self.res_idx),
            cg_xyz=arr(self.ca_xyz),
            cg_mask=arr(self.cg_mask),
            mapping=ids(self.mapping),
            channel_idx=ids(self.channel_idx),
            nbrs=ids(self.nbrs),
            nbr_mask=arr(self.nbr_mask),
            cg_nbrs=ids(self.nbrs),
            cg_nbr_mask=arr(self.nbr_mask),
            bonds=ids(self.bonds),
            bond_mask=arr(self.bond_mask),
        )

    def ca_mask_for(self, idx: np.ndarray) -> np.ndarray:
        return self.ca_flag[idx]

    def dihedrals_for(self, idx: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        return self.dihe_quads[idx], self.dihe_mask[idx]

    def iter_batches(
        self, batch_size: int, rng: Optional[np.random.Generator] = None,
        drop_last: bool = True,
    ) -> Iterator[Tuple[CGBatch, np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (batch, ca_mask, dihe_quads, dihe_mask)."""
        order = np.arange(len(self))
        if rng is not None:
            rng.shuffle(order)
        # always yield at least one (padded) batch, even when the
        # split is smaller than batch_size
        stop = max(len(self) - batch_size + 1, 1) if drop_last else len(self)
        for lo in range(0, stop, batch_size):
            idx = order[lo : lo + batch_size]
            if idx.shape[0] < batch_size:
                idx = np.resize(np.concatenate([idx, order]), batch_size)
            yield (
                self.batch(idx),
                self.ca_mask_for(idx),
                *self.dihedrals_for(idx),
            )


def sidechainnet_items(
    split: dict,
    n_data: Optional[int] = None,
    max_len: Optional[int] = None,
) -> List[Tuple[str, np.ndarray]]:
    """SidechainNet split dict {'seq': [...], 'crd': [...], 'msk': [...]}
    -> (seq, crd) items for build_pcn_dataset.

    Mirrors the original code's ingestion (get_sidechainet_props,
    sidechain.py:187-329; run flow
    run_pdb.py:265-291): SEQ_BLACKLIST entries are dropped, and residues
    whose resolution mask is not "+" are DROPPED from seq/crd and the rest
    renumbered (reference mask_seq semantics, sidechain.py:163-164 + the
    resolved-only `map` counter at :270-287) -- an unresolved residue must
    not survive as a zero-coordinate CG bead.
    """
    seqs, crds = split["seq"], split["crd"]
    msks = split.get("msk")
    items: List[Tuple[str, np.ndarray]] = []
    for i, seq in enumerate(seqs):
        if seq in SEQ_BLACKLIST:
            continue
        if max_len is not None and len(seq) > max_len:
            continue
        crd = np.asarray(crds[i], np.float32).reshape(
            len(seq), NUM_COORDS_PER_RES, 3
        )
        if msks is not None:
            resolved = np.array([c == "+" for c in msks[i]], bool)
            if not resolved.all():
                seq = "".join(s for s, r in zip(seq, resolved) if r)
                crd = crd[resolved]
        if len(seq) == 0 or not np.any(crd[:, 1]):  # no resolved C-alpha
            continue
        items.append((seq, crd))
        if n_data is not None and len(items) >= n_data:
            break
    return items


def load_sidechainnet(
    source: str,
    split: str = "train",
    thinning: int = 30,
    n_data: Optional[int] = None,
    max_len: Optional[int] = None,
) -> List[Tuple[str, np.ndarray]]:
    """Load a SidechainNet dataset and return (seq, crd) items for one split.

    source: a path to a SidechainNet pickle on disk (the file scn.load
    caches, a dict of split dicts; no sidechainnet package needed), or a
    CASP spec like "casp12" resolved by the sidechainnet package
    (scripts/run_pdb.py:265 of the original code, ``scn.load(dataset,
    thinning=30)``), imported only then. Raises ImportError with
    instructions when that package is needed but not installed.
    """
    import os
    import pickle

    if os.path.exists(source):
        with open(source, "rb") as f:
            data = pickle.load(f)
    else:
        try:
            import sidechainnet as scn
        except ImportError as e:
            raise ImportError(
                f"source {source!r} is not a file and the sidechainnet "
                "package is not installed; either install sidechainnet or "
                "point source at a SidechainNet pickle (the scn.load cache "
                "file)"
            ) from e
        data = scn.load(source, thinning=thinning)
    if split not in data:
        raise KeyError(
            f"split {split!r} not in SidechainNet data; have {sorted(data)}"
        )
    return sidechainnet_items(data[split], n_data=n_data, max_len=max_len)


def build_pcn_dataset(
    items: Sequence[Tuple[str, np.ndarray]],
    cg_cutoff: float = 10.0,
    n_pad: Optional[int] = None,
    l_pad: Optional[int] = None,
) -> PCNDatasetArrays:
    """(seq, crd) items -> padded arrays. cg_cutoff builds the C-alpha
    radius graph the PCN decoder runs over (run_pdb.py uses a CG cutoff on
    the C-alpha trace)."""
    props = [protein_props(seq, crd) for seq, crd in items]
    quads = [backbone_dihedral_quads(p) for p in props]

    # C-alpha radius graphs (directed) per protein
    cg_edges = []
    for p in props:
        e = make_directed(radius_graph_dense(p.ca_xyz, cg_cutoff))
        # receiver-sorted (segment sums use indices_are_sorted=True)
        cg_edges.append(e[np.argsort(e[:, 0], kind="stable")])

    s = len(props)
    n_max = n_pad or max(p.z.shape[0] for p in props)
    l_max = l_pad or max(len(p.seq) for p in props)
    e_max = max(max(e.shape[0] for e in cg_edges), 1)
    eb_max = max(max(p.bonds.shape[0] for p in props), 1)
    q_max = max(max(q.shape[0] for q in quads), 1)

    out = PCNDatasetArrays(
        z=np.zeros((s, n_max), np.int32),
        xyz=np.zeros((s, n_max, 3), np.float32),
        atom_mask=np.zeros((s, n_max), bool),
        res_idx=np.zeros((s, l_max), np.int32),
        ca_xyz=np.zeros((s, l_max, 3), np.float32),
        cg_mask=np.zeros((s, l_max), bool),
        mapping=np.zeros((s, n_max), np.int32),
        channel_idx=np.zeros((s, n_max), np.int32),
        ca_flag=np.zeros((s, n_max), bool),
        # (l_max-1, l_max-1) padding keeps the receiver column sorted
        nbrs=np.full((s, e_max, 2), l_max - 1, dtype=np.int32),
        nbr_mask=np.zeros((s, e_max), bool),
        bonds=np.zeros((s, eb_max, 2), np.int32),
        bond_mask=np.zeros((s, eb_max), bool),
        dihe_quads=np.zeros((s, q_max, 4), np.int32),
        dihe_mask=np.zeros((s, q_max), bool),
        seqs=[p.seq for p in props],
    )
    for i, p in enumerate(props):
        n, L = p.z.shape[0], len(p.seq)
        out.z[i, :n] = p.z
        out.xyz[i, :n] = p.xyz
        out.atom_mask[i, :n] = True
        out.res_idx[i, :L] = p.res_idx
        out.ca_xyz[i, :L] = p.ca_xyz
        out.cg_mask[i, :L] = True
        out.mapping[i, :n] = p.mapping
        out.channel_idx[i, :n] = p.channel_idx
        out.ca_flag[i, :n] = p.ca_flag
        e = cg_edges[i]
        out.nbrs[i, : e.shape[0]] = e
        out.nbr_mask[i, : e.shape[0]] = True
        out.bonds[i, : p.bonds.shape[0]] = p.bonds
        out.bond_mask[i, : p.bonds.shape[0]] = True
        q = quads[i]
        out.dihe_quads[i, : q.shape[0]] = q
        out.dihe_mask[i, : q.shape[0]] = True
    return out
