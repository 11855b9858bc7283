"""Evaluation in the PyTorch port against the JAX package: the structure
metrics, the analysis helpers, the xyz/movie writers, the run loggers, the
trajectory loader, and ``sample_ensemble`` / ``reconstruct_all``.

The metrics, analysis and writers are host numpy in both packages and must
agree exactly (array_equal, byte-identical files). ``sample_ensemble`` and
``reconstruct_all`` are held exactly to the JAX functions with trainers
whose ``generate``/``reconstruct`` are stubs returning the same arrays
(tiling, wrap-padding, reflection and the statistics), then end to end on
converted parameters with ``det=True`` at f32 (rtol 1e-4 / atol 1e-5, the
serving slice's gate)."""
import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, TrainConfig
from coarsegrainingvae_tpu.data import proteins as jproteins
from coarsegrainingvae_tpu.eval import analysis as janalysis
from coarsegrainingvae_tpu.eval import metrics as jmetrics
from coarsegrainingvae_tpu.eval import sampling as jsampling
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu.utils import logging as jlogging
from coarsegrainingvae_tpu.utils import visualization as jvis
from coarsegrainingvae_tpu.utils import xyz as jxyz
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data import proteins
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.eval import analysis, metrics, sampling
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.train.trainer import Trainer
from coarsegrainingvae_tpu_torch.utils import logging as tlogging
from coarsegrainingvae_tpu_torch.utils import visualization as tvis
from coarsegrainingvae_tpu_torch.utils import xyz as txyz

torch.set_num_threads(1)

Z = np.array([6, 1, 1, 1, 6, 8, 7, 1, 6, 1, 6, 1, 1, 1, 16], np.int32)
BONDS = np.array([[0, 1], [0, 2], [0, 3], [0, 4], [4, 5], [4, 6], [6, 7], [6, 8],
                  [8, 9], [8, 10], [10, 11], [10, 12], [10, 13], [8, 14]])


def _structures(seed=0, s=6, jitter=0.2):
    """A reference chain with 1.1-1.5 A bonds and s jittered copies, some of
    them valid, some not."""
    rng = np.random.default_rng(seed)
    ref = np.cumsum(rng.normal(size=(Z.shape[0], 3)) * 0.8, axis=0)
    gen = ref[None] + rng.normal(size=(s, Z.shape[0], 3)) * jitter * rng.uniform(0, 1, (s, 1, 1))
    return ref.astype(np.float32), gen.astype(np.float32)


def _same(a, b):
    """Exact equality of two results (arrays, floats, dicts, None)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif a is None or b is None:
        assert a is None and b is None
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


METRIC_CASES = {
    "bond_cutoff_matrix": lambda m, ref, gen: m.bond_cutoff_matrix(Z, 1.2),
    "bond_graphs_batch": lambda m, ref, gen: m.bond_graphs_batch(gen, Z),
    "valid_ratio": lambda m, ref, gen: m.valid_ratio(
        m.bond_graphs_batch(ref[None], Z)[0], m.bond_graphs_batch(gen, Z)),
    "graph_diff_ratio": lambda m, ref, gen: m.graph_diff_ratio(
        m.bond_graphs_batch(ref[None], Z)[0], m.bond_graphs_batch(gen, Z)),
    "graph_edit_ratio": lambda m, ref, gen: m.graph_edit_ratio(
        m.bond_graphs_batch(ref[None], Z)[0], m.bond_graphs_batch(gen, Z)),
    "compute_rmsd_batch": lambda m, ref, gen: m.compute_rmsd_batch(
        gen, ref, Z, np.arange(gen.shape[0]) % 2 == 0),
    "compute_rmsd_batch_none_valid": lambda m, ref, gen: m.compute_rmsd_batch(
        gen, ref, Z, np.zeros(gen.shape[0], bool)),
    "evaluate_samples": lambda m, ref, gen: m.evaluate_samples(ref, gen, Z),
    "unaligned_rmsd_np": lambda m, ref, gen: m.unaligned_rmsd_np(gen[0], ref),
    "tetrahedral_indices": lambda m, ref, gen: m.tetrahedral_indices(Z, BONDS),
    "compute_hch": lambda m, ref, gen: m.compute_hch(gen, m.tetrahedral_indices(Z, BONDS)),
}


@pytest.mark.parametrize("name", sorted(METRIC_CASES))
def test_metric_equals_jax(name):
    for seed in range(3):
        ref, gen = _structures(seed)
        _same(METRIC_CASES[name](metrics, ref, gen), METRIC_CASES[name](jmetrics, ref, gen))


def test_evaluate_samples_sees_valid_and_invalid_structures():
    ref, gen = _structures(1, s=16)
    q = metrics.evaluate_samples(ref, gen, Z)
    assert 0.0 < q["valid_allatom_ratio"] < 1.0
    assert q["all_rmsds"].shape[1] == 2


def _cv_dir(root, name, rows):
    d = root / name
    d.mkdir()
    logger = jlogging.CSVLogger(str(d / "cv_stats.csv"), ["fold", "rmsd", "tag"])
    for row in rows:
        logger.log(row)
    return d


ANALYSIS_CASES = {
    "tica": lambda a, feats, xyz, tmp: a.tica(feats, lag=3, dim=2),
    "pairwise_distance_features": lambda a, feats, xyz, tmp: a.pairwise_distance_features(
        xyz, stride=2),
    "bond_length_distribution": lambda a, feats, xyz, tmp: a.bond_length_distribution(
        xyz, BONDS),
    "read_csv_rows": lambda a, feats, xyz, tmp: a.read_csv_rows(
        str(tmp / "run_a" / "cv_stats.csv")),
    "get_cv_stats": lambda a, feats, xyz, tmp: a.get_cv_stats(str(tmp / "run_a")),
    "collect_runs": lambda a, feats, xyz, tmp: a.collect_runs(str(tmp / "run_*")),
}


@pytest.mark.parametrize("name", sorted(ANALYSIS_CASES))
def test_analysis_equals_jax(name, tmp_path):
    rng = np.random.default_rng(3)
    xyz = np.cumsum(rng.normal(size=(40, Z.shape[0], 3)), axis=0) * 0.1
    feats = janalysis.pairwise_distance_features(xyz)
    _cv_dir(tmp_path, "run_a", [{"fold": 0, "rmsd": 1.5, "tag": "x"},
                                {"fold": 1, "rmsd": float("nan"), "tag": "y"}])
    _cv_dir(tmp_path, "run_b", [{"fold": 0, "rmsd": 2.5, "tag": "z"}])
    (tmp_path / "run_c").mkdir()                      # no cv_stats.csv: skipped
    _same(ANALYSIS_CASES[name](analysis, feats, xyz, tmp_path),
          ANALYSIS_CASES[name](janalysis, feats, xyz, tmp_path))


def test_write_xyz_and_movies_are_byte_identical(tmp_path):
    _, gen = _structures(2, s=5)
    cg = gen[:, :3] * 0.5
    for pkg, name in ((txyz, "port"), (jxyz, "jax")):
        pkg.write_xyz(str(tmp_path / f"{name}.xyz"), gen, Z, comment="frames")
        pkg.write_xyz(str(tmp_path / f"{name}_one.xyz"), gen[0], Z)
    for vis, name in ((tvis, "port"), (jvis, "jax")):
        vis.save_grid_snapshots(gen, gen[::-1], gen * 1.01, cg, Z, np.full(3, 6),
                                str(tmp_path / name), n_frames=7)
    for f in ("", "_one"):
        assert (tmp_path / f"port{f}.xyz").read_bytes() == (tmp_path / f"jax{f}.xyz").read_bytes()
    movies = sorted(os.listdir(tmp_path / "jax"))
    assert movies == [f"rotate_{k}.xyz" for k in ("cg", "data", "ensemble", "recon")]
    assert sorted(os.listdir(tmp_path / "port")) == movies
    for m in movies:
        assert (tmp_path / "port" / m).read_bytes() == (tmp_path / "jax" / m).read_bytes()
    z, frames = txyz.read_xyz(str(tmp_path / "jax.xyz"))
    jz, jframes = jxyz.read_xyz(str(tmp_path / "jax.xyz"))
    np.testing.assert_array_equal(z, jz)
    np.testing.assert_array_equal(frames, jframes)
    np.testing.assert_array_equal(tvis.rotate_grid(gen, 5, axis=2), jvis.rotate_grid(gen, 5, axis=2))
    np.testing.assert_array_equal(tvis.xyz_grid_view(gen, 2, 3.0), jvis.xyz_grid_view(gen, 2, 3.0))


def test_loggers_are_byte_identical(tmp_path):
    rows = [{"epoch": 0, "lr": 2e-4, "loss": 3.25, "extra": 1},
            {"epoch": 1, "lr": 1.2e-4, "loss": float("nan"), "extra": 2}]
    for pkg, name in ((tlogging, "port"), (jlogging, "jax")):
        first = pkg.CSVLogger(str(tmp_path / f"{name}.csv"))
        first.log(rows[0])
        # a second logger on the same file (a resumed fold) appends, no header
        pkg.CSVLogger(str(tmp_path / f"{name}.csv")).log(rows[1])
        pkg.CSVLogger(str(tmp_path / f"{name}_fields.csv"), ["loss", "epoch"]).log(rows[0])
        for row in rows:
            pkg.JSONLLogger(str(tmp_path / f"{name}.jsonl")).log(row)
    for suffix in (".csv", "_fields.csv", ".jsonl"):
        assert (tmp_path / f"port{suffix}").read_bytes() == (tmp_path / f"jax{suffix}").read_bytes()
    assert (tmp_path / "port.csv").read_text().count("epoch") == 1
    assert tlogging.annotate_job("newman_sample", "run", 3) == jlogging.annotate_job(
        "newman_sample", "run", 3)


def test_load_frames_npz_branch_equals_jax(tmp_path, monkeypatch):
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(12, Z.shape[0], 3)).astype(np.float32)
    proteins.save_npz_traj(str(tmp_path / "toy.npz"), Z, xyz, BONDS)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    assert proteins.data_root() == jproteins.data_root() == str(tmp_path)
    for ndata, shuffle in ((5, True), (12, False)):
        got = proteins.load_frames("toy", ndata, seed=4, shuffle=shuffle, device="cpu")
        want = jproteins.load_frames("toy", ndata, seed=4, shuffle=shuffle)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    assert proteins.load_traj_atom_names("toy") is None
    names = np.array([f"A{i}" for i in range(Z.shape[0])])
    np.savez_compressed(tmp_path / "named.npz", z=Z, xyz=xyz, bonds=BONDS, atom_names=names)
    assert proteins.load_traj_atom_names("named") == jproteins.load_traj_atom_names("named")
    assert proteins.load_traj_atom_names("missing") is None
    assert proteins._load_mdtraj("dipeptide", 4) is None          # no mdtraj here
    assert proteins.PROTEINFILES == jproteins.PROTEINFILES
    assert proteins.ATOMIC_NUM == jproteins.ATOMIC_NUM


def test_load_frames_synthetic_cache_shares_the_jax_key(tmp_path, monkeypatch):
    """Without an npz or mdtraj the synthetic frames are made on the given
    device and cached under the JAX package's key; either package reads the
    other's cache file."""
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "none"))
    monkeypatch.setattr("tempfile.tempdir", str(tmp_path))
    z, frames, bonds = proteins.load_frames("dipeptide", 6, seed=3, device="cpu")
    cache = tmp_path / "cgvae_synth_cache" / "v7_dipeptide_6_3.npz"
    assert cache.exists() and frames.shape == (6, z.shape[0], 3)
    again = proteins.load_frames("dipeptide", 6, seed=3, device="cpu")
    want = jproteins.load_frames("dipeptide", 6, seed=3)
    for a, b, w in zip((z, frames, bonds), again, want):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, w)


# ------------------------------------------------ sampling with stub models
def _recon_stub(xyz):
    return xyz + 0.04 * np.sin(7.0 * xyz)


def _gen_stub(xyz):
    return xyz + 0.3 * np.cos(3.0 * xyz + xyz.sum(-1, keepdims=True))


class _JaxStub:
    def reconstruct(self, params, batch, rng):
        return _recon_stub(np.asarray(batch.xyz)).reshape(-1, 3)

    def generate(self, params, batch, rng):
        return _gen_stub(np.asarray(batch.xyz)).reshape(-1, 3)


class _PortStub:
    device = torch.device("cpu")

    def reconstruct(self, batch, generator):
        assert isinstance(generator, torch.Generator)
        return torch.as_tensor(_recon_stub(batch.xyz.numpy())).reshape(-1, 3)

    def generate(self, batch, generator):
        return torch.as_tensor(_gen_stub(batch.xyz.numpy())).reshape(-1, 3)


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


@pytest.mark.parametrize("reflection", [False, True])
@pytest.mark.parametrize("graph_eval", [False, True])
def test_sampling_with_stub_models_equals_jax(small_dataset, reflection, graph_eval):
    ds = _port_dataset(small_dataset)
    # 32 frames at batch 12: the last batch is padded by wrap-around
    got = sampling.reconstruct_all(_PortStub(), ds, 0, batch_size=12,
                                   graph_eval=graph_eval, reflection=reflection)
    want = jsampling.reconstruct_all(_JaxStub(), None, small_dataset, jax.random.PRNGKey(0),
                                     batch_size=12, graph_eval=graph_eval,
                                     reflection=reflection)
    _same(got, want)
    frames = np.array([0, 5, 31])
    got = sampling.sample_ensemble(_PortStub(), ds, frames, 4, 0, graph_eval=graph_eval,
                                   reflection=reflection)
    want = jsampling.sample_ensemble(_JaxStub(), None, small_dataset, frames, 4,
                                     jax.random.PRNGKey(0), graph_eval=graph_eval,
                                     reflection=reflection)
    _same(got, want)
    if graph_eval:
        assert set(got) >= {"sample_valid", "all_rmsds", "sample_graph_val_ratio"}


def test_reconstruct_all_matches_jax_on_converted_parameters(small_dataset, tiny_model_cfg):
    mcfg = dataclasses.replace(tiny_model_cfg, det=True, compute_dtype="float32")
    cfg = ExperimentConfig(model=mcfg, data=DataConfig(batch_size=12, seed=0),
                           train=TrainConfig(lr=1e-3))
    jtr = JaxTrainer(JaxModel(cfg=mcfg), cfg, mesh=make_mesh(1))
    jstate = jtr.init_state(small_dataset.batch(np.arange(12)), seed=0)
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    model = DenseCGVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    tr = Trainer(model, tc, device="cpu")
    got = sampling.reconstruct_all(tr, _port_dataset(small_dataset), 1, batch_size=12)
    want = jsampling.reconstruct_all(jtr, jstate.params, small_dataset, jax.random.PRNGKey(1),
                                     batch_size=12)
    np.testing.assert_array_equal(got["true_xyzs"], want["true_xyzs"])
    np.testing.assert_allclose(got["recon_xyzs"], want["recon_xyzs"], rtol=1e-4, atol=1e-5)
    for key in ("all_atom_rmsd", "heavy_atom_rmsd", "all_atom_rmsd_median",
                "heavy_atom_rmsd_p99"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    # one step under inference mode leaves no autograd state behind
    assert all(p.grad is None for p in model.parameters())
