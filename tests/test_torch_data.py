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
