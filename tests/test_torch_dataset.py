"""The training data path of the PyTorch port against the JAX package:
topology edges, radius graphs, build_dataset, batches, the device-resident
gather, epoch index batches, k-fold splits, and the host-side LR and
early-stopping controllers. The same inputs and seeds must give the same
arrays."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.data import dataset as jds_mod
from coarsegrainingvae_tpu.data import device as jdev
from coarsegrainingvae_tpu.data import neighbors as jnb
from coarsegrainingvae_tpu.data import topology as jtop
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu.train import controller as jctl
from coarsegrainingvae_tpu_torch.data import dataset as tds_mod
from coarsegrainingvae_tpu_torch.data import device as tdev
from coarsegrainingvae_tpu_torch.data import neighbors as tnb
from coarsegrainingvae_tpu_torch.data import topology as ttop
from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
from coarsegrainingvae_tpu_torch.train import controller as tctl

torch.set_num_threads(1)

BATCH_FIELDS = ("z", "xyz", "atom_mask", "cg_z", "cg_xyz", "cg_mask", "mapping",
                "channel_idx", "bonds", "bond_mask")


@pytest.fixture(scope="module")
def peptide():
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=12, seed=3)
    return z, frames, bonds, newman_mapping(bonds, z.shape[0], 3, seed=0)


def _assert_same(a, b, name=""):
    a = a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    np.testing.assert_array_equal(a, np.asarray(b), err_msg=name)


def test_topology_and_radius_graphs_match(peptide):
    z, frames, bonds, mapping = peptide
    n = z.shape[0]
    for order in (1, 2, 3):
        _assert_same(ttop.high_order_edges(bonds, order, n), jtop.high_order_edges(bonds, order, n))
    _assert_same(ttop.adjacency_from_edges(bonds, n), jtop.adjacency_from_edges(bonds, n))
    _assert_same(ttop.cg_graph_from_bonds(bonds, mapping, n, 3),
                 jtop.cg_graph_from_bonds(bonds, mapping, n, 3))
    _assert_same(tnb.make_directed(bonds), jnb.make_directed(bonds))
    _assert_same(tnb.make_directed(tnb.make_directed(bonds)), jnb.make_directed(bonds))
    for cutoff, directed, max_edges in ((4.0, True, None), (2.5, False, None), (4.0, True, 700)):
        got = tnb.radius_graph_frames(frames, cutoff, max_edges=max_edges, directed=directed)
        want = jnb.radius_graph_frames(frames, cutoff, max_edges=max_edges, directed=directed)
        for a, b in zip(got, want):
            _assert_same(a, b)
    with pytest.raises(ValueError, match="budget"):
        tnb.radius_graph_frames(frames, 4.0, max_edges=8)


@pytest.mark.parametrize("kw", [dict(), dict(cg_cutoff=None, rotate=False),
                                dict(order=1, seed=9, aux_cutoff=2.0)])
def test_build_dataset_matches_jax(peptide, kw):
    z, frames, bonds, mapping = peptide
    args = dict(atom_cutoff=8.5, cg_cutoff=9.5, atomic_nums=z, bonds=bonds, order=2,
                rotate=True)
    args.update(kw)
    got = tds_mod.build_dataset(mapping, frames, **args)
    want = jds_mod.build_dataset(mapping, frames, **args)
    for name in ("z", "xyz", "cg_xyz", "mapping", "channel_idx", "bonds", "nbrs",
                 "nbr_mask", "cg_nbrs", "cg_nbr_mask", "aux_bonds", "aux_mask"):
        a, b = getattr(got, name), getattr(want, name)
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype, name
            _assert_same(a, b, name)
    assert got.n_cgs == want.n_cgs and len(got) == len(want)

    idx = np.array([5, 0, 7, 7])
    tb, jb = got.batch(idx), want.batch(idx)
    for name in BATCH_FIELDS:
        _assert_same(getattr(tb, name), getattr(jb, name), name)
    sub_t, sub_j = got.subset(np.arange(2, 9)), want.subset(np.arange(2, 9))
    for tb, jb in zip(sub_t.iter_batches(3, rng=np.random.default_rng(4)),
                      sub_j.iter_batches(3, rng=np.random.default_rng(4))):
        for name in BATCH_FIELDS:
            _assert_same(getattr(tb, name), getattr(jb, name), name)


def test_device_gather_and_epoch_batches_match(peptide):
    z, frames, bonds, mapping = peptide
    ds_j = jds_mod.build_dataset(mapping, frames, 8.5, 9.5, z, bonds, order=2)
    ds_t = tds_mod.build_dataset(mapping, frames, 8.5, 9.5, z, bonds, order=2)
    dds_j = jdev.DeviceDataset.from_dataset(ds_j)
    dds_t = tdev.DeviceDataset.from_dataset(ds_t, "cpu")
    for n_frames, bs, seed in ((12, 5, 0), (12, 4, 1), (3, 8, None)):
        rng_t = None if seed is None else np.random.default_rng(seed)
        rng_j = None if seed is None else np.random.default_rng(seed)
        _assert_same(tdev.epoch_index_batches(n_frames, bs, rng_t),
                     jdev.epoch_index_batches(n_frames, bs, rng_j))
    idx = np.array([11, 2, 2, 6], np.int32)
    tb = dds_t.gather(torch.as_tensor(idx, dtype=torch.long))
    jb = dds_j.gather(jnp.asarray(idx))
    for name in BATCH_FIELDS:
        _assert_same(getattr(tb, name), getattr(jb, name), name)
    for name in BATCH_FIELDS:                            # same as the host batch
        _assert_same(getattr(tb, name), getattr(ds_t.batch(idx), name), name)
    aux = tds_mod.build_dataset(mapping, frames, 8.5, 9.5, z, bonds, aux_cutoff=2.0)
    with pytest.raises(ValueError, match="aux"):
        tdev.DeviceDataset.from_dataset(aux, "cpu")


def test_kfold_indices_match():
    for n, k, seed in ((20, 5, 123), (17, 3, 0)):
        for (a, b), (c, d) in zip(tds_mod.kfold_indices(n, k, seed), jds_mod.kfold_indices(n, k, seed)):
            _assert_same(a, c)
            _assert_same(b, d)


def test_controllers_match_jax():
    rng = np.random.default_rng(0)
    losses = 5.0 * np.exp(-np.arange(30) / 6.0) + rng.normal(scale=0.2, size=30)
    losses[20:] = losses[20]                             # a plateau
    np.testing.assert_array_equal(tctl.lowess_smooth(losses, frac=0.3),
                                  jctl.lowess_smooth(losses, frac=0.3))
    ct = tctl.LowessPlateauController(lr=1e-3, patience=1)
    cj = jctl.LowessPlateauController(lr=1e-3, patience=1)
    st, sj = tctl.EarlyStopping(patience=3), jctl.EarlyStopping(patience=3)
    for x in losses:
        assert ct.step(x) == cj.step(x)
        st(x)
        sj(x)
        assert (ct.lr, ct.converged, st.early_stop, st.counter) == (
            cj.lr, cj.converged, sj.early_stop, sj.counter)
    assert ct.save_state() == cj.save_state() and st.save_state() == sj.save_state()
