"""The port's protein data path (SidechainNet-style props and datasets,
synthetic atom14 proteins, PDB files, the cache CLI) against the JAX
package's.

Host numpy on both sides: equal inputs give equal arrays, files byte for
byte. The one torch step is the well-posed atom14 relaxation, which the
JAX package jits; the port runs it in torch (here on the CPU) in another
summation order, so its coordinates agree within ``RELAX_ATOL``, as
``relax_frames``' do (tests/test_torch_data.py), and the truth bond graphs
it is relaxed for are the same trees.
"""
import pickle

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.cli import generate_cache as jcache
from coarsegrainingvae_tpu.data import proteins as jproteins
from coarsegrainingvae_tpu.data import sidechain as jsc
from coarsegrainingvae_tpu.data import synthetic as jsyn
from coarsegrainingvae_tpu.utils import pdb as jpdb
from coarsegrainingvae_tpu_torch.cli import generate_cache
from coarsegrainingvae_tpu_torch.data import proteins, sidechain, synthetic
from coarsegrainingvae_tpu_torch.utils import pdb

torch.set_num_threads(1)

# the atom14 relaxation in float32, summed in another order than XLA's, as
# for relax_frames (tests/test_torch_data.py)
RELAX_ATOL = 1e-3
ARRAYS = ("z", "xyz", "atom_mask", "res_idx", "ca_xyz", "cg_mask", "mapping", "channel_idx",
          "ca_flag", "nbrs", "nbr_mask", "bonds", "bond_mask", "dihe_quads", "dihe_mask")


@pytest.fixture(scope="module")
def items():
    """Four proteins of 6-14 residues; one with missing side-chain atoms."""
    out = [jsyn.synthetic_protein(n, seed=s) for n, s in ((6, 0), (9, 1), (14, 2))]
    out.append(jsyn.synthetic_protein(11, seed=3, missing_frac=0.3))
    return out


def test_tables_equal_jax():
    for name in ("ATOM_MAP_14", "AMINO_ACIDS", "RES2IDX", "ATOM_NAMES", "ATOM2IDX", "ATOM2Z",
                 "SEQ_BLACKLIST", "_COV_RADII"):
        assert getattr(sidechain, name) == getattr(jsc, name), name


def test_protein_props_and_dihedral_quads_equal_jax(items):
    for seq, crd in items:
        want, got = jsc.protein_props(seq, crd), sidechain.protein_props(seq, crd)
        for f in ("z", "atom_idx", "xyz", "mapping", "channel_idx", "res_idx", "ca_xyz",
                  "ca_flag", "bonds"):
            np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
        np.testing.assert_array_equal(sidechain.backbone_dihedral_quads(got),
                                      jsc.backbone_dihedral_quads(want))


def test_build_pcn_dataset_equals_jax(items):
    want = jsc.build_pcn_dataset(items, cg_cutoff=10.0)
    got = sidechain.build_pcn_dataset(items, cg_cutoff=10.0)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f)
    assert got.seqs == want.seqs
    idx = np.array([2, 0])
    sub, jsub = got.subset(idx), want.subset(idx)
    for f in ARRAYS:
        np.testing.assert_array_equal(getattr(sub, f), getattr(jsub, f), err_msg=f)
    # iter_batches pads a short split by cycling, as the JAX package does
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    for (b, cam, q, qm), (jb, jcam, jq, jqm) in zip(got.iter_batches(3, rng=rng),
                                                    want.iter_batches(3, rng=jrng)):
        for f in ("z", "xyz", "cg_z", "cg_xyz", "mapping", "channel_idx", "cg_nbrs",
                  "cg_nbr_mask", "bonds", "bond_mask"):
            np.testing.assert_array_equal(getattr(b, f).numpy(), np.asarray(getattr(jb, f)),
                                          err_msg=f)
        for a, ja in ((cam, jcam), (q, jq), (qm, jqm)):
            np.testing.assert_array_equal(a, ja)


@pytest.mark.parametrize("n_res,seed,missing", [(6, 0, 0.0), (13, 5, 0.0), (9, 2, 0.4)])
def test_synthetic_protein_default_path_is_bit_equal(n_res, seed, missing):
    seq, crd = synthetic.synthetic_protein(n_res, seed=seed, missing_frac=missing, device="cpu")
    jseq, jcrd = jsyn.synthetic_protein(n_res, seed=seed, missing_frac=missing)
    assert seq == jseq
    np.testing.assert_array_equal(crd, jcrd)
    assert synthetic.intended_atom14_bonds(seq) == jsyn.intended_atom14_bonds(seq)


@pytest.mark.parametrize("n_res,seed", [(8, 0), (12, 3)])
def test_synthetic_protein_well_posed_matches_jax(n_res, seed):
    seq, crd = synthetic.synthetic_protein(n_res, seed=seed, well_posed=True, device="cpu")
    jseq, jcrd = jsyn.synthetic_protein(n_res, seed=seed, well_posed=True)
    assert seq == jseq
    np.testing.assert_allclose(crd, jcrd, rtol=0, atol=RELAX_ATOL)
    p, jp = sidechain.protein_props(seq, crd), jsc.protein_props(jseq, jcrd)
    got = {tuple(e) for e in p.bonds.tolist()}
    assert got == {tuple(e) for e in jp.bonds.tolist()}
    # a tree: one bond fewer than atoms, the intended topology
    assert len(got) == p.z.shape[0] - 1
    # the same bits on a second call
    _, again = synthetic.synthetic_protein(n_res, seed=seed, well_posed=True, device="cpu")
    np.testing.assert_array_equal(again, crd)


def test_write_and_parse_pdb_equal_jax(tmp_path, items):
    seq, crd = items[3]
    p = sidechain.protein_props(seq, crd)
    pdb.write_pdb(str(tmp_path / "port.pdb"), seq, p.xyz, p.mapping, p.channel_idx)
    jpdb.write_pdb(str(tmp_path / "jax.pdb"), seq, p.xyz, p.mapping, p.channel_idx)
    assert (tmp_path / "port.pdb").read_bytes() == (tmp_path / "jax.pdb").read_bytes()
    got, jgot = pdb.parse_pdb(str(tmp_path / "port.pdb")), jpdb.parse_pdb(str(tmp_path / "jax.pdb"))
    assert got[0] == jgot[0] == seq
    np.testing.assert_array_equal(got[1], jgot[1])
    assert pdb.format_atom_line(7, "CA", "ALA", "A", 3, (1.0, -2.5, 30.25), "C") == \
        jpdb.format_atom_line(7, "CA", "ALA", "A", 3, (1.0, -2.5, 30.25), "C")


def _pdb_dir(path, items, frames_of_one=False):
    path.mkdir()
    if frames_of_one:
        # same-topology frames: one protein, jittered
        seq, crd = items[0]
        rng = np.random.default_rng(0)
        for k in range(3):
            p = sidechain.protein_props(seq, crd)
            xyz = p.xyz + rng.normal(scale=0.05, size=p.xyz.shape).astype(np.float32)
            pdb.write_pdb(str(path / f"f{k:03d}.pdb"), seq, xyz, p.mapping, p.channel_idx)
    else:
        for i, (seq, crd) in enumerate(items[:3]):
            p = sidechain.protein_props(seq, crd)
            pdb.write_pdb(str(path / f"T{i:04d}.pdb"), seq, p.xyz, p.mapping, p.channel_idx)
    return path


def test_pdb_dirs_and_generate_cache_equal_jax(tmp_path, items):
    targets = _pdb_dir(tmp_path / "targets", items)
    got, want = pdb.load_pdb_dir(str(targets)), jpdb.load_pdb_dir(str(targets))
    assert [(i, s) for i, s, _ in got] == [(i, s) for i, s, _ in want]
    for (_, _, c), (_, _, jc) in zip(got, want):
        np.testing.assert_array_equal(c, jc)

    generate_cache.main(["-kind", "protein", "-src", str(targets), "-out",
                         str(tmp_path / "port.npz")])
    jcache.main(["-kind", "protein", "-src", str(targets), "-out", str(tmp_path / "jax.npz")])
    with np.load(tmp_path / "port.npz") as a, np.load(tmp_path / "jax.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)

    frames = _pdb_dir(tmp_path / "frames", items, frames_of_one=True)
    z, xyz, bonds = proteins.traj_npz_from_pdb_frames(str(frames))
    jz, jxyz, jbonds = jproteins.traj_npz_from_pdb_frames(str(frames))
    for a, b in ((z, jz), (xyz, jxyz), (bonds, jbonds)):
        np.testing.assert_array_equal(a, b)
    generate_cache.main(["-kind", "pdbtraj", "-src", str(frames), "-out",
                         str(tmp_path / "traj_port.npz")])
    jcache.main(["-kind", "pdbtraj", "-src", str(frames), "-out", str(tmp_path / "traj_jax.npz")])
    with np.load(tmp_path / "traj_port.npz") as a, np.load(tmp_path / "traj_jax.npz") as b:
        assert sorted(a.files) == sorted(b.files) == ["atom_names", "bonds", "xyz", "z"]
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_load_sidechainnet_pickle_round_trip(tmp_path, items):
    (seq, crd), (seq2, crd2) = items[0], items[1]
    split = {"seq": [seq, jsc.SEQ_BLACKLIST[0], seq2],
             "crd": [crd.reshape(-1, 3),
                     np.zeros((len(jsc.SEQ_BLACKLIST[0]) * 14, 3), np.float32),
                     crd2.reshape(-1, 3)],
             "msk": ["+" * len(seq), "+" * len(jsc.SEQ_BLACKLIST[0]),
                     "+-" + "+" * (len(seq2) - 2)]}
    path = tmp_path / "scn.pkl"
    with open(path, "wb") as f:
        pickle.dump({"train": split}, f)
    got = sidechain.load_sidechainnet(str(path), split="train")
    want = jsc.load_sidechainnet(str(path), split="train")
    assert [s for s, _ in got] == [s for s, _ in want] == [seq, seq2[0] + seq2[2:]]
    for (_, c), (_, jc) in zip(got, want):
        np.testing.assert_array_equal(c, jc)
    with pytest.raises(KeyError):
        sidechain.load_sidechainnet(str(path), split="valid")
