"""The baseline zoo of the PyTorch port against the JAX package's, on the
CPU: every model's forward and one training step (metrics, gradients and
the updated parameters) on the same converted weights at f32, the kNN
order on exact ties, ``fit``, and ``run_baseline`` beside the JAX CLI.
Neither package runs a Pallas or CUDA kernel on this path."""
import csv
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.cli import run_baseline as jcli
from coarsegrainingvae_tpu.data.diffpool import build_diffpool_dataset as jbuild
from coarsegrainingvae_tpu.data.mappings import newman_mapping
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu.data.topology import channel_index_from_mapping
from coarsegrainingvae_tpu.models import baseline as jbl
from coarsegrainingvae_tpu.train.baseline_trainer import BaselineTrainer as JaxBaselineTrainer
from coarsegrainingvae_tpu_torch.cli import run_baseline
from coarsegrainingvae_tpu_torch.convert import convert_baseline_params
from coarsegrainingvae_tpu_torch.data import topology
from coarsegrainingvae_tpu_torch.data.diffpool import build_diffpool_dataset
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
from coarsegrainingvae_tpu_torch.models import baseline
from coarsegrainingvae_tpu_torch.train.baseline_trainer import BaselineTrainer

torch.set_num_threads(1)

# f32: the same arithmetic in another order (flax vs torch matmuls)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
N_CGS, BATCH = 4, 8
ZOO = ("linear", "mlp", "equimlp", "equimlp2", "setequimlp", "edgesetmlp", "equilinear")


@pytest.fixture(scope="module")
def data():
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=24, seed=0)
    mapping = newman_mapping(bonds, z.shape[0], N_CGS, seed=0)
    return (z, frames, bonds, mapping, jbuild(frames, z, bonds),
            build_diffpool_dataset(frames, z, bonds))


def _kwargs(name, mapping):
    kw = {}
    if name in ("equimlp", "equimlp2", "setequimlp"):
        kw = dict(knn=3, width=2, depth=1, activation="ReLU")
    elif name == "mlp":
        kw = dict(width=2, depth=1, activation="ReLU")
    elif name in ("edgesetmlp", "equilinear"):
        kw = dict(knn=3)
    if name == "setequimlp":
        kw.update(channel_idx=channel_index_from_mapping(mapping),
                  n_channels=topology.max_atoms_per_bead(mapping))
    return kw


def _pair(name, data):
    z, frames, _, mapping, _, _ = data
    jm = jbl.build_baseline(name, N_CGS, z.shape[0], mapping, **_kwargs(name, mapping))
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(frames[:BATCH]))["params"]
    tm = baseline.build_baseline(name, N_CGS, z.shape[0], mapping, **_kwargs(name, mapping))
    tm.load_state_dict(convert_baseline_params(jax.device_get(params), name))
    return jm, params, tm


@pytest.mark.parametrize("name", ZOO)
def test_baseline_forward_matches_jax(data, name):
    jm, params, tm = _pair(name, data)
    xyz = data[1][:BATCH].astype(np.float32)
    target, recon = jm.apply({"params": params}, jnp.asarray(xyz))
    with torch.no_grad():
        t_target, t_recon = tm(torch.as_tensor(xyz))
    np.testing.assert_allclose(t_recon.numpy(), np.asarray(recon), **F32_TOL)
    np.testing.assert_allclose(t_target.numpy(), np.asarray(target), **F32_TOL)


@pytest.mark.parametrize("name", ZOO)
def test_baseline_step_matches_jax(data, name):
    """One step of each trainer from the same weights at lr 1e-6: the
    metrics, the gradients (as Adam's first moment, 0.1 g) and the updated
    parameters (Adam's first step moves each by at most lr)."""
    jm, params, tm = _pair(name, data)
    jds, tds = data[4], data[5]
    jtr = JaxBaselineTrainer(jm, gamma=5.0, lr=1e-6)
    jstate = jtr.init_state(jds.batch(np.arange(BATCH)))
    jstate = jstate.replace(params=params, opt_state=jtr.tx.init(params))
    jnew, jmetrics = jtr._train_step(jstate, jds.batch(np.arange(BATCH)))
    ttr = BaselineTrainer(tm, gamma=5.0, lr=1e-6, device="cpu")
    tnew, tmetrics = ttr.train_step(ttr.init_state(), tds.batch(np.arange(BATCH)))
    assert set(tmetrics) == set(jmetrics)
    for k in jmetrics:
        np.testing.assert_allclose(float(tmetrics[k]), float(jmetrics[k]), rtol=1e-5, err_msg=k)
    assert tnew.step == int(jnew.step) == 1
    jmu = convert_baseline_params(jax.device_get(jnew.opt_state.mu), name)
    jparams = convert_baseline_params(jax.device_get(jnew.params), name)
    mus = dict(zip(tnew.params, torch.split(tnew.opt_state.mu,
                                            [p.numel() for p in tnew.params.values()])))
    assert set(mus) == set(jmu)
    for k, p in tnew.params.items():
        want = jmu[k].numpy() / 0.1
        np.testing.assert_allclose(mus[k].reshape(p.shape).numpy() / 0.1, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=k)
        np.testing.assert_allclose(p.detach().numpy(), jparams[k].numpy(), **F32_TOL, err_msg=k)


def test_knn_order_on_a_tie():
    """Beads on a square and its centre: every corner has two neighbours at
    the same distance. Both take the lower bead index first."""
    cg = np.array([[[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0], [0.5, 0.5, 0]],
                   [[0, 0, 0], [2, 0, 0], [0, 2, 0], [-2, 0, 0], [0, -2, 0]]], np.float32)
    for knn in (1, 2, 3, 4):
        jvec, jd = jbl.knn_edge_vectors(jnp.asarray(cg), knn)
        tvec, td = baseline.knn_edge_vectors(torch.as_tensor(cg), knn)
        np.testing.assert_array_equal(tvec.numpy(), np.asarray(jvec))
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6)
    # corner 0 of the square: the centre (0.71), then beads 1 and 3 at 1.0
    np.testing.assert_array_equal(baseline.knn_edge_vectors(torch.as_tensor(cg), 3)[0][0, 0],
                                  [[0.5, 0.5, 0], [1, 0, 0], [0, 1, 0]])


@pytest.mark.parametrize("n_cgs", [3, 4])
def test_equimlp_on_a_complete_knn_graph_reconstructs_the_anchors(data, n_cgs):
    """The reference's own behaviour (ROADMAP.md C): when the clamped knn
    reaches every other bead (n_cgs - 1), each edge comes with its reverse
    at the same length, so equimlp's per-edge sum cancels, dx = 0, and
    both packages put every atom on its bead whatever the weights (the
    committed baseline_demo recipe, n_cgs 3, learns nothing)."""
    z, frames, bonds = data[:3]
    mapping = newman_mapping(bonds, z.shape[0], n_cgs, seed=0)
    kw = dict(knn=3, width=1, depth=1, activation="ReLU")
    xyz = frames[:BATCH].astype(np.float32)
    jm = jbl.build_baseline("equimlp", n_cgs, z.shape[0], mapping, **kw)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(xyz))["params"]
    _, jrecon = jm.apply({"params": params}, jnp.asarray(xyz))
    tm = baseline.build_baseline("equimlp", n_cgs, z.shape[0], mapping, **kw)
    _, trecon = tm(torch.as_tensor(xyz))
    idx = torch.as_tensor(np.asarray(mapping, np.int64))
    _, _, cg_xyz = baseline.fixed_pool(idx, n_cgs, torch.as_tensor(xyz))
    anchors = cg_xyz[:, idx].numpy()
    np.testing.assert_allclose(trecon.detach().numpy(), anchors, atol=1e-5)
    np.testing.assert_allclose(np.asarray(jrecon), anchors, atol=1e-5)
    grads = torch.autograd.grad(trecon.square().sum(), list(tm.parameters()))
    assert max(float(g.abs().max()) for g in grads) < 1e-4


def test_build_baseline_clamps_knn(data):
    mapping = data[3]
    for name in ("equimlp", "edgesetmlp", "equilinear"):
        assert baseline.build_baseline(name, 3, 27, mapping % 3, knn=5).knn == 2


def test_fit_history_matches_jax(data):
    """Two epochs of ``fit`` (two steps each) from the same weights."""
    jm, params, tm = _pair("equimlp", data)
    jds, tds = data[4], data[5]
    jtr = JaxBaselineTrainer(jm, gamma=5.0, lr=1e-3)
    jstate = jtr.init_state(jds.batch(np.arange(BATCH)))
    jstate = jstate.replace(params=params, opt_state=jtr.tx.init(params))
    idx = np.arange(len(jds))
    _, jhist = jtr.fit(jstate, jds.subset(idx[:16]), jds.subset(idx[16:]), nepochs=2,
                       batch_size=BATCH)
    ttr = BaselineTrainer(tm, gamma=5.0, lr=1e-3, device="cpu")
    _, thist = ttr.fit(ttr.init_state(), tds.subset(idx[:16]), tds.subset(idx[16:]),
                       nepochs=2, batch_size=BATCH)
    assert len(thist) == len(jhist) == 2
    for trow, jrow in zip(thist, jhist):
        assert list(trow) == list(jrow)
        for k in trow:
            if k != "epoch_time_s":
                np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4, err_msg=k)


CLI_ARGS = ["-model", "setequimlp", "-n_cgs", "3", "-ndata", "24", "-nepochs", "2",
            "-batch_size", "4", "-gamma", "5", "-lr", "3e-4"]


def test_cli_writes_the_jax_files_and_columns(tmp_path, monkeypatch, data):
    z, frames, bonds = data[:3]
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    jrows = jcli.main(CLI_ARGS + ["-logdir", str(tmp_path / "jax" / "run")])
    trows = run_baseline.main(CLI_ARGS + ["-logdir", str(tmp_path / "port" / "run"),
                                          "--device", "cpu"])
    assert len(trows) == len(jrows) == 2 and list(trows[0]) == list(jrows[0])
    (jrun,), (trun,) = (list((tmp_path / k).iterdir()) for k in ("jax", "port"))
    assert jrun.name == trun.name
    files = {p.relative_to(jrun).as_posix() for p in jrun.rglob("*") if p.is_file()}
    assert files == {p.relative_to(trun).as_posix() for p in trun.rglob("*") if p.is_file()}
    for name in ("cv_stats.csv", "fold0/train_log.csv", "fold1/train_log.csv"):
        with open(jrun / name, newline="") as f:
            jr = csv.DictReader(f)
            jrows_csv = list(jr)
        with open(trun / name, newline="") as f:
            tr = csv.DictReader(f)
            trows_csv = list(tr)
        assert tr.fieldnames == jr.fieldnames and len(trows_csv) == len(jrows_csv), name
        assert all(np.isfinite(float(v)) for row in trows_csv for v in row.values()), name
    jp = json.loads((jrun / "modelparams.json").read_text())
    tp = json.loads((trun / "modelparams.json").read_text())
    assert {k: v for k, v in tp.items() if k not in ("device", "logdir")} == \
        {k: v for k, v in jp.items() if k != "logdir"} and tp["device"] == "cpu"
