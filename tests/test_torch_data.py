"""Data side of the PyTorch port against the JAX package: config, mappings,
topology, covalent radii, bead centroids, and the synthetic dipeptide with
its relaxation rewritten in torch."""
import dataclasses

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu import config as jcfg
from coarsegrainingvae_tpu.data import mappings as jmap
from coarsegrainingvae_tpu.data import synthetic as jsyn
from coarsegrainingvae_tpu.data.dataset import _segment_mean_np as jax_segment_mean
from coarsegrainingvae_tpu.data.topology import channel_index_from_mapping as jax_channels
from coarsegrainingvae_tpu.eval.metrics import COVALENT_RADII as JAX_RADII
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.data import mappings as tmap
from coarsegrainingvae_tpu_torch.data import synthetic as tsyn
from coarsegrainingvae_tpu_torch.data.dataset import _segment_mean_np
from coarsegrainingvae_tpu_torch.data.topology import channel_index_from_mapping
from coarsegrainingvae_tpu_torch.eval.metrics import COVALENT_RADII

torch.set_num_threads(1)

# relax_frames: 300 float32 steepest-descent steps from identical inputs;
# XLA and torch order the force sums differently (float32 rounding, ~1e-7
# relative per step), and the descent damps rather than amplifies such
# differences, so coordinates agree to well under a thousandth of an
# Angstrom (bond lengths are ~1-1.5 A, the covalent cutoff margin ~0.1 A).
RELAX_ATOL = 1e-3


@pytest.fixture(scope="module")
def dipeptide():
    return jsyn.synthetic_peptide("dipeptide", n_frames=8, seed=0)


def test_config_round_trips_between_packages():
    assert dataclasses.asdict(tcfg.DIPEPTIDE_BENCH) == dataclasses.asdict(jcfg.DIPEPTIDE_BENCH)
    assert dataclasses.asdict(tcfg.ExperimentConfig()) == dataclasses.asdict(jcfg.ExperimentConfig())
    loaded = tcfg.ExperimentConfig.from_json(jcfg.CHIGNOLIN_BENCH.to_json())
    assert dataclasses.asdict(loaded) == dataclasses.asdict(jcfg.CHIGNOLIN_BENCH)


def test_covalent_radii_and_channels_match(dipeptide):
    assert COVALENT_RADII == JAX_RADII
    z, frames, bonds = dipeptide
    mapping = jmap.newman_mapping(bonds, z.shape[0], 3, seed=0)
    np.testing.assert_array_equal(channel_index_from_mapping(mapping), jax_channels(mapping))
    np.testing.assert_array_equal(_segment_mean_np(frames, mapping, 3),
                                  jax_segment_mean(frames, mapping, 3))


@pytest.mark.parametrize("method", ["newman", "random", "seqpartition", "spectral",
                                    "minimal", "alpha"])
def test_mappings_match(dipeptide, method):
    z, frames, bonds = dipeptide
    kw = dict(bonds=bonds, frames=frames, z=z, seed=1)
    np.testing.assert_array_equal(tmap.get_mapping(method, 3, z.shape[0], **kw),
                                  jmap.get_mapping(method, 3, z.shape[0], **kw))
    np.testing.assert_array_equal(
        tmap.newman_mapping(bonds, z.shape[0], 4, mapshuffle=0.2, seed=3),
        jmap.newman_mapping(bonds, z.shape[0], 4, mapshuffle=0.2, seed=3))


def test_relax_frames_matches_jax(dipeptide):
    z, frames, bonds = dipeptide
    rng = np.random.default_rng(0)
    # perturbed frames with clashes for the descent to resolve
    start = frames + rng.normal(scale=0.3, size=frames.shape).astype(np.float32)
    rest = np.linalg.norm(frames[0, bonds[:, 0]] - frames[0, bonds[:, 1]], axis=-1)
    ref = jsyn.relax_frames(z, start, bonds, rest, margin=1.3)
    out = tsyn.relax_frames(z, start, bonds, rest, margin=1.3, device="cpu")
    assert out.dtype == np.float64 and out.shape == start.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=RELAX_ATOL)
    assert np.abs(out - start).max() > 0.05          # the descent did move atoms


def test_synthetic_dipeptide_matches_jax(dipeptide):
    """Same numpy generator; only relax_frames differs. The repair loop
    makes discrete choices from graph_violations, which agree here, so the
    frames agree to the relaxation tolerance."""
    z, frames, bonds = dipeptide
    tz, tframes, tbonds = tsyn.synthetic_peptide("dipeptide", n_frames=8, seed=0,
                                                    device="cpu")
    np.testing.assert_array_equal(tz, z)
    np.testing.assert_array_equal(tbonds, bonds)
    assert tframes.dtype == np.float32 and tframes.shape == frames.shape
    np.testing.assert_allclose(tframes, frames, rtol=0, atol=RELAX_ATOL)
    assert (tsyn.graph_violations(tz, tframes, tbonds) == 0).all()


# CG graphs: a chain, a ring with a chord, the dipeptide's bond-contracted
# graph, two disconnected parts, an isolated bead, one bead alone (with and
# without a self edge), and edges given in both directions
CG_GRAPHS = {
    "chain": (np.array([[0, 1], [1, 2], [2, 3]]), 4),
    "ring_chord": (np.array([[0, 1], [1, 2], [2, 3], [3, 4], [4, 0], [1, 3]]), 5),
    "two_parts": (np.array([[0, 1], [2, 3]]), 4),
    "isolated_bead": (np.array([[0, 1], [1, 2]]), 4),
    "one_bead": (np.zeros((0, 2), np.int32), 1),
    "one_bead_self_edge": (np.array([[0, 0]]), 1),
    "both_directions": (np.array([[0, 1], [1, 0], [2, 1], [1, 2]]), 3),
    "no_edges": (np.zeros((0, 2), np.int32), 3),
}


@pytest.mark.parametrize("name", sorted(CG_GRAPHS))
def test_check_cg_connected_matches_jax(name):
    from coarsegrainingvae_tpu.data.topology import check_cg_connected as jax_check
    from coarsegrainingvae_tpu_torch.data.topology import check_cg_connected

    edges, n = CG_GRAPHS[name]
    got = check_cg_connected(edges, n)
    assert got is jax_check(edges, n)
    assert got is (name not in ("two_parts", "isolated_bead", "no_edges"))


def test_check_cg_connected_on_the_dipeptide_graph_matches_jax(dipeptide):
    from coarsegrainingvae_tpu.data.topology import cg_graph_from_bonds as jax_cg_graph
    from coarsegrainingvae_tpu.data.topology import check_cg_connected as jax_check
    from coarsegrainingvae_tpu_torch.data.topology import cg_graph_from_bonds, check_cg_connected

    z, _, bonds = dipeptide
    for n_cgs in (1, 3, 6):
        mapping = jmap.newman_mapping(bonds, z.shape[0], n_cgs, seed=0)
        edges = cg_graph_from_bonds(bonds, mapping, z.shape[0], n_cgs)
        np.testing.assert_array_equal(edges, jax_cg_graph(bonds, mapping, z.shape[0], n_cgs))
        assert check_cg_connected(edges, n_cgs) is jax_check(edges, n_cgs) is True
        # drop every edge of bead 0: it is cut off from the rest
        cut = edges[(edges != 0).all(1)]
        assert check_cg_connected(cut, n_cgs) is jax_check(cut, n_cgs) is (n_cgs == 1)


@pytest.mark.parametrize("b,n,m", [(1, 1, 1), (4, 27, 3), (2, 209, 6)])
def test_cg_batch_sizes_match_jax(b, n, m):
    """batch_size, n_atoms and n_cgs of the port's CGBatch against the JAX
    CGBatch's on the same shapes, one bead and one atom included."""
    import jax.numpy as jnp

    from coarsegrainingvae_tpu.data.batch import CGBatch as JaxBatch
    from coarsegrainingvae_tpu_torch.data.batch import CGBatch

    def ints(*shape):
        return np.zeros(shape, np.int32)

    arrs = dict(z=ints(b, n), xyz=np.zeros((b, n, 3), np.float32),
                atom_mask=np.ones((b, n), bool), cg_z=ints(b, m),
                cg_xyz=np.zeros((b, m, 3), np.float32), cg_mask=np.ones((b, m), bool),
                mapping=ints(b, n), channel_idx=ints(b, n))
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrs.items()},
                  nbrs=jnp.zeros((b, 1, 2), jnp.int32), nbr_mask=jnp.zeros((b, 1), bool),
                  cg_nbrs=jnp.zeros((b, 1, 2), jnp.int32), cg_nbr_mask=jnp.zeros((b, 1), bool),
                  bonds=jnp.zeros((b, 1, 2), jnp.int32), bond_mask=jnp.zeros((b, 1), bool))
    tb = CGBatch(**{k: torch.as_tensor(v) for k, v in arrs.items()})
    assert (tb.batch_size, tb.n_atoms, tb.n_cgs) == (jb.batch_size, jb.n_atoms, jb.n_cgs)
    assert (tb.batch_size, tb.n_atoms, tb.n_cgs) == (b, n, m)
