"""DiffPool of the PyTorch port against the JAX package's, on the CPU: the
dense blocks, ``DiffPoolVAE`` in each ``CGpool`` mode (forward and
``sample``), the train and pretrain steps of the v6 loss, a few epochs of
``fit``, the dataset's batches, and ``run_diffpool`` beside the JAX CLI.

Both sides run f32 on the same converted parameters. The JAX package draws
its gumbel and reparametrisation noise inside its flax modules, so the
tests replace ``jax.random.uniform`` / ``jax.random.normal`` with functions
that return chosen draws while the JAX side is applied (never while it is
initialised), and hand the port the same draws (``u``, ``eps``, or the
trainer's ``noise``). Nothing in the JAX package changes. Neither package
runs a Pallas or CUDA kernel on this path.
"""
import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.cli import run_diffpool as jcli
from coarsegrainingvae_tpu.config import DiffPoolConfig as JaxDiffPoolConfig
from coarsegrainingvae_tpu.data import diffpool as jdata
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu.models import dense as jdense
from coarsegrainingvae_tpu.models import diffpool as jdp
from coarsegrainingvae_tpu.train import diffpool_trainer as jtrainer
from coarsegrainingvae_tpu.train.losses import build_steric_tables
from coarsegrainingvae_tpu_torch.cli import run_diffpool
from coarsegrainingvae_tpu_torch.config import DiffPoolConfig
from coarsegrainingvae_tpu_torch.convert import convert_diffpool_params, load_params
from coarsegrainingvae_tpu_torch.data import diffpool as tdata
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
from coarsegrainingvae_tpu_torch.models import dense
from coarsegrainingvae_tpu_torch.models.diffpool import DiffPoolVAE, bond_adjacency, tau_schedule
from coarsegrainingvae_tpu_torch.train.diffpool_trainer import DiffPoolTrainer

torch.set_num_threads(1)

# f32: the same arithmetic in another order (flax vs torch matmuls and
# einsums)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, N_ATOMS, N_CGS, WIDTH = 4, 27, 4, 16
MODES = ("trainable_map", "logits", "fixed")


@pytest.fixture(scope="module")
def frames():
    z, xyz, bonds = synthetic_peptide("dipeptide", n_frames=24, seed=0)
    assert z.shape == (N_ATOMS,)
    return z, xyz, bonds


@pytest.fixture(scope="module")
def datasets(frames):
    z, xyz, bonds = frames
    return (jdata.build_diffpool_dataset(xyz, z, bonds, rotate=True, seed=5),
            tdata.build_diffpool_dataset(xyz, z, bonds, rotate=True, seed=5))


def _cfg(mode="trainable_map", **kw):
    return JaxDiffPoolConfig(n_atoms=N_ATOMS, n_cgs=N_CGS, feat_dim=WIDTH, n_rbf=4, enc_nconv=2,
                             dec_nconv=2, trainable_map=mode == "trainable_map", **kw)


def _assign_idx(mode):
    return tuple(i % N_CGS for i in range(N_ATOMS)) if mode == "fixed" else None


def _jargs(jb):
    return jnp.asarray(jb.z), jnp.asarray(jb.xyz), jnp.asarray(jb.adj)


def _pair(jb, cfg, assign_idx=None):
    jm = jdp.DiffPoolVAE(cfg=cfg, assign_idx=assign_idx)
    params = jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
                      "sample": jax.random.PRNGKey(2)}, *_jargs(jb),
                     jnp.asarray(cfg.tau_0))["params"]
    tm = DiffPoolVAE(DiffPoolConfig(**dataclasses.asdict(cfg)), assign_idx)
    tm.load_state_dict(convert_diffpool_params(jax.device_get(params), tm.cfg))
    return jm, params, tm


def _draws(tm, seed=0):
    """(u, eps) of one call: u in [1e-3, 1) so that -log(-log(u)) is tame."""
    rng = np.random.default_rng(seed)
    shape = tm.pooler.noise_shape(BATCH, N_ATOMS)
    u = None if shape is None else rng.uniform(1e-3, 1.0, size=shape).astype(np.float32)
    return u, rng.normal(size=(BATCH, N_CGS, WIDTH)).astype(np.float32)


def _patched(mp, u, eps):
    """jax.random.uniform / normal return the chosen draws."""
    if u is not None:
        mp.setattr(jax.random, "uniform",
                   lambda key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0:
                   jnp.asarray(u, dtype).reshape(shape))
    mp.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
               jnp.asarray(eps, dtype).reshape(shape))


def _t(a):
    return None if a is None else torch.as_tensor(a)


RNGS = {"gumbel": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)}


# ------------------------------------------------------------------ blocks
@pytest.fixture(scope="module")
def block_model(datasets):
    jds, tds = datasets
    jb, tb = jds.batch(np.arange(BATCH)), tds.batch(np.arange(BATCH))
    jm, params, tm = _pair(jb, _cfg("fixed"), _assign_idx("fixed"))
    pool = jm.apply({"params": params}, *_jargs(jb), jnp.asarray(1.0),
                    method=lambda m, *a: m.pool(*a))
    with torch.no_grad():
        tpool = tm.pooler(tb.z, tb.xyz, tb.adj, 1.0)
    return jm, params, tm, pool, tpool, jb


def _message_tree(p):
    inv = p["DenseInvariantMessage_0"]
    return {"inv.phi_in.weight": inv["Dense_0"]["Dense_0"]["kernel"].T,
            "inv.phi_in.bias": inv["Dense_0"]["Dense_0"]["bias"],
            "inv.phi_out.weight": inv["Dense_1"]["Dense_0"]["kernel"].T,
            "inv.phi_out.bias": inv["Dense_1"]["Dense_0"]["bias"],
            "inv.embed.dense.weight": inv["DistanceEmbed_0"]["Dense_0"]["Dense_0"]["kernel"].T,
            "inv.embed.dense.bias": inv["DistanceEmbed_0"]["Dense_0"]["Dense_0"]["bias"]}


@pytest.mark.parametrize("cross", [False, True], ids=["painn", "cross"])
def test_dense_message_block_matches_jax(cross):
    rng = np.random.default_rng(1)
    b, n, f = 3, 6, WIDTH
    xyz = rng.normal(scale=2.0, size=(b, n, 3)).astype(np.float32)
    s = rng.normal(size=(b, n, f)).astype(np.float32)
    v = rng.normal(size=(b, n, 3, f)).astype(np.float32)
    adj_w = rng.uniform(size=(b, n, n)).astype(np.float32) * (1 - np.eye(n, dtype=np.float32))
    jblock = jdense.DenseEquiMessageBlock(feat_dim=f, activation="swish", n_rbf=4,
                                          cutoff=5.0, cross=cross)
    _, dist, unit = jdense.dense_pairwise(jnp.asarray(xyz))
    args = (jnp.asarray(s), jnp.asarray(v), dist, unit, jnp.asarray(adj_w))
    params = jblock.init(jax.random.PRNGKey(0), *args)["params"]
    ds, dv = jblock.apply({"params": params}, *args)
    tblock = dense.DenseEquiMessageBlock(f, "swish", 4, 5.0, cross=cross)
    tblock.load_state_dict({k: torch.as_tensor(np.array(a))
                            for k, a in _message_tree(jax.device_get(params)).items()})
    _, tdist, tunit = dense.dense_pairwise(torch.as_tensor(xyz))
    with torch.no_grad():
        tds, tdv = tblock(torch.as_tensor(s), torch.as_tensor(v), tdist, tunit,
                          torch.as_tensor(adj_w))
    np.testing.assert_allclose(tds.numpy(), np.asarray(ds), **F32_TOL)
    np.testing.assert_allclose(tdv.numpy(), np.asarray(dv), **F32_TOL)


def test_degree_norm_adjacency_matches_jax():
    adj = np.ones((2, 5, 5), np.float32) - np.eye(5, dtype=np.float32)
    adj[1, 2, :] = adj[1, :, 2] = 0.0      # an isolated bead: rsqrt_safe gives 0
    np.testing.assert_allclose(dense.degree_norm_adjacency(torch.as_tensor(adj)).numpy(),
                               np.asarray(jdense.degree_norm_adjacency(jnp.asarray(adj))),
                               **F32_TOL)


@pytest.mark.parametrize("block", ["contract", "encoder", "prior", "decoder"])
def test_dense_diffpool_blocks_match_jax(block_model, block):
    """Each block inside the model, on the pooler's outputs, with the
    converted weights."""
    jm, params, tm, pool, tpool, jb = block_model
    xyz = jnp.asarray(jb.xyz) - jnp.mean(jnp.asarray(jb.xyz), axis=1, keepdims=True)
    txyz = torch.as_tensor(np.asarray(xyz))
    with torch.no_grad():
        if block == "contract":
            v = np.random.default_rng(2).normal(size=(BATCH, N_ATOMS, 3, WIDTH)).astype(np.float32)
            enc = jdense.DenseContract(feat_dim=WIDTH, activation="swish", cutoff=8.0)
            p = jax.device_get(params["encoder"]["DenseContract_0"])
            ref = enc.apply({"params": p}, pool.assign, pool.h, jnp.asarray(v), pool.cg_xyz, xyz)
            got = tm.encoder.contract[0](tpool.assign, tpool.h, torch.as_tensor(v),
                                         tpool.cg_xyz, txyz)
        elif block == "encoder":
            ref = jm.apply({"params": params}, pool.h, pool.H, xyz, pool.cg_xyz, pool.assign,
                           method=lambda m, *a: m.encoder(*a))
            got = tm.encoder(tpool.h, tpool.H, txyz, tpool.cg_xyz, tpool.assign)
        elif block == "prior":
            ref = jm.apply({"params": params}, pool.H, pool.cg_adj, pool.cg_xyz,
                           method=lambda m, *a: m.prior_net(*a))
            got = tm.prior_net(tpool.H, tpool.cg_adj, tpool.cg_xyz)
        else:
            ref = jm.apply({"params": params}, pool.H, pool.cg_adj, pool.cg_xyz,
                           method=lambda m, *a: m.decoder(*a))
            got = tm.decoder(tpool.H, tpool.cg_adj, tpool.cg_xyz)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **F32_TOL)


# ------------------------------------------------------------------- model
@pytest.mark.parametrize("mode", MODES)
def test_diffpool_forward_matches_jax(datasets, mode, monkeypatch):
    jds, tds = datasets
    jb, tb = jds.batch(np.arange(BATCH)), tds.batch(np.arange(BATCH))
    jm, params, tm = _pair(jb, _cfg(mode), _assign_idx(mode))
    u, eps = _draws(tm)
    with monkeypatch.context() as mp:
        _patched(mp, u, eps)
        ref = jm.apply({"params": params}, *_jargs(jb), jnp.asarray(1.3), rngs=RNGS)
    with torch.no_grad():
        out = tm(tb.z, tb.xyz, tb.adj, 1.3, u=_t(u), eps=_t(eps))
    for f in ("xyz", "xyz_recon", "assign", "cg_xyz", "mu", "sigma", "prior_mu", "prior_sigma"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   **F32_TOL, err_msg=f)


@pytest.mark.parametrize("hard", [False, True], ids=["soft", "hard"])
@pytest.mark.parametrize("mode", MODES)
def test_diffpool_sample_matches_jax(datasets, mode, hard, monkeypatch):
    jds, tds = datasets
    jb, tb = jds.batch(np.arange(BATCH)), tds.batch(np.arange(BATCH))
    jm, params, tm = _pair(jb, _cfg(mode), _assign_idx(mode))
    u, eps = _draws(tm, seed=1)
    with monkeypatch.context() as mp:
        _patched(mp, u, eps)
        ref = jm.apply({"params": params}, *_jargs(jb), jnp.asarray(0.3), hard,
                       method=jm.sample, rngs=RNGS)
    with torch.no_grad():
        got = tm.sample(tb.z, tb.xyz, tb.adj, 0.3, hard=hard, u=_t(u), eps=_t(eps))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_tau_schedule_matches_jax():
    for step in (0, 1, 7, 250, 5000):
        assert tau_schedule(step, 2.0, 0.1, 0.004) == pytest.approx(
            float(jdp.tau_schedule(step, 2.0, 0.1, 0.004)), rel=1e-6)


# ----------------------------------------------------------------- training
# the v6 recipe's loss terms at a small width (graph_grad, zeta and the H
# projection), read mid-ramp
V6 = dict(beta=0.02, gamma=25.0, zeta=50.0, graph_grad=True, zeta_warmup=10,
          graph_warmup=10, h_project=True)


def _trainers(frames, jb, mode="trainable_map", lr=1e-6, **kw):
    """The JAX trainer and state, and the port's on the JAX weights."""
    z, _, bonds = frames
    cfg = _cfg(mode, tau_min=0.1)
    steric = build_steric_tables(z, bonds, margin=0.3)
    common = dict(lr=lr, assign_idx=_assign_idx(mode), seed=123, steric_tables=steric,
                  **dict(V6, **kw))
    jtr = jtrainer.DiffPoolTrainer(cfg, **common)
    jstate = jtr.init_state(jb)
    ttr = DiffPoolTrainer(DiffPoolConfig(**dataclasses.asdict(cfg)), device="cpu", **common)
    ttr.model.load_state_dict(convert_diffpool_params(jax.device_get(jstate.params), ttr.cfg))
    return jtr, jstate, ttr, ttr.init_state()


def _fixed_noise(ttr, u, eps):
    ttr.noise = lambda key, batch_size: (_t(u), _t(eps))


def _assert_step_matches(tnew, jnew, cfg):
    """The gradients (read as Adam's first moment after one step from
    zero moments, 0.1 g) and the updated parameters. At lr 1e-6 the first
    Adam step, g / (|g| + 1e-8), moves every parameter by at most 1e-6,
    whichever sign a near-zero gradient rounds to."""
    jmu = convert_diffpool_params(jax.device_get(jnew.opt_state.mu), cfg)
    jparams = convert_diffpool_params(jax.device_get(jnew.params), cfg)
    grads = dict(zip(tnew.params, torch.split(tnew.opt_state.mu, [
        p.numel() for p in tnew.params.values()])))
    for name, p in tnew.params.items():
        want = jmu[name].numpy() / 0.1
        np.testing.assert_allclose(grads[name].reshape(p.shape).numpy() / 0.1, want, rtol=1e-4,
                                   atol=1e-5 * max(np.abs(want).max(), 1.0), err_msg=name)
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(), **F32_TOL,
                                   err_msg=name)


@pytest.mark.parametrize("mode", ["trainable_map", "logits"])
def test_train_step_matches_jax_mid_ramp(frames, datasets, mode, monkeypatch):
    """One step at step 5 of 10-step ramps: the metrics, the gradients (as
    the first Adam moment, 0.1 g) and the updated parameters."""
    jds, tds = datasets
    jb, tb = jds.batch(np.arange(BATCH)), tds.batch(np.arange(BATCH))
    jtr, jstate, ttr, tstate = _trainers(frames, jb, mode)
    u, eps = _draws(ttr.model, seed=2)
    with monkeypatch.context() as mp:
        _patched(mp, u, eps)
        jnew, jm = jtr.train_step(jstate.replace(step=jnp.asarray(5, jnp.int32)), jb,
                                  jax.random.PRNGKey(9))
    _fixed_noise(ttr, u, eps)
    tstate.step = 5
    tnew, tm = ttr.train_step(tstate, tb, (0,))
    assert set(tm) == set(jm) and "steric" in tm
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-4, err_msg=k)
    assert tnew.step == int(jnew.step) == 6
    _assert_step_matches(tnew, jnew, ttr.cfg)


def test_pretrain_step_matches_jax(frames, datasets, monkeypatch):
    """A pretrain step with per-atom logits: the loss, Adam's count
    advanced with ``step`` held, and the gradients and updated parameters
    (only the pooler's move)."""
    jds, tds = datasets
    jb, tb = jds.batch(np.arange(BATCH)), tds.batch(np.arange(BATCH))
    jtr, jstate, ttr, tstate = _trainers(frames, jb, mode="logits")
    target = np.arange(N_ATOMS) % N_CGS
    u, eps = _draws(ttr.model, seed=3)
    before = convert_diffpool_params(jax.device_get(jstate.params), ttr.cfg)  # donated below
    with monkeypatch.context() as mp:
        _patched(mp, u, eps)
        jnew, jloss = jtr._pretrain_step(jstate, jb, jax.random.PRNGKey(0),
                                         jax.nn.one_hot(jnp.asarray(target), N_CGS))
    _fixed_noise(ttr, u, eps)
    tnew, tloss = ttr.pretrain_step(
        tstate, tb, (0,), torch.nn.functional.one_hot(torch.as_tensor(target), N_CGS).float())
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5)
    assert tnew.step == int(jnew.step) == 0 and int(tnew.opt_state.count) == 1
    after = convert_diffpool_params(jax.device_get(jnew.params), ttr.cfg)
    moved = [k for k in after if not np.array_equal(after[k], before[k])]
    assert moved and all(k.startswith("pooler.") for k in moved)
    _assert_step_matches(tnew, jnew, ttr.cfg)


def test_fit_history_matches_jax(frames, datasets, monkeypatch):
    """Two epochs of ``fit`` (3 steps each, ramps of 4 steps holding the
    controller) on the same batches with the same draws at every step:
    the history rows and the final parameters within tolerance."""
    jds, tds = datasets
    idx = np.arange(len(jds))
    jtr, jstate, ttr, tstate = _trainers(frames, jds.batch(idx[:BATCH]), lr=1e-4,
                                         zeta_warmup=4, graph_warmup=4)
    u, eps = _draws(ttr.model, seed=4)
    with monkeypatch.context() as mp:
        _patched(mp, u, eps)
        jstate, jhist = jtr.fit(jstate, jds.subset(idx[:12]), jds.subset(idx[12:20]),
                                nepochs=2, batch_size=BATCH)
    _fixed_noise(ttr, u, eps)
    tstate, thist = ttr.fit(tstate, tds.subset(idx[:12]), tds.subset(idx[12:20]),
                            nepochs=2, batch_size=BATCH)
    assert len(thist) == len(jhist) == 2
    for trow, jrow in zip(thist, jhist):
        assert list(trow) == list(jrow)
        for k in trow:
            if k != "epoch_time_s":
                np.testing.assert_allclose(trow[k], jrow[k], rtol=1e-4, err_msg=k)
    jparams = convert_diffpool_params(jax.device_get(jstate.params), ttr.cfg)
    for name, p in tstate.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jparams[name].numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=name)


# -------------------------------------------------------------------- data
def test_dataset_batches_are_bit_equal(frames):
    """rotate + shift, the shuffled order and the wrap-padded last batch,
    and the bond adjacency."""
    z, xyz, bonds = frames
    jds = jdata.build_diffpool_dataset(xyz[:10], z, bonds, rotate=True, shift=True, seed=7)
    tds = tdata.build_diffpool_dataset(xyz[:10], z, bonds, rotate=True, shift=True, seed=7)
    for f in ("z", "xyz", "bonds", "adj", "angles", "dihedrals"):
        np.testing.assert_array_equal(getattr(tds, f), getattr(jds, f), err_msg=f)
    assert tds.angles.shape[0] > 0 and tds.dihedrals.shape[0] > 0
    for drop_last in (True, False):
        jb = list(jds.iter_batches(4, rng=np.random.default_rng(1), drop_last=drop_last))
        tb = list(tds.iter_batches(4, rng=np.random.default_rng(1), drop_last=drop_last))
        assert len(tb) == len(jb) == (2 if drop_last else 3)
        for j, t in zip(jb, tb):
            for f in ("z", "xyz", "adj", "bonds", "angles", "dihedrals"):
                np.testing.assert_array_equal(getattr(t, f).numpy(), getattr(j, f), err_msg=f)
    np.testing.assert_array_equal(
        bond_adjacency(torch.as_tensor(bonds.astype(np.int64)), N_ATOMS).numpy(),
        np.asarray(jdp.bond_adjacency(jnp.asarray(bonds), N_ATOMS)))
    # a split smaller than a batch still yields one, wrap-padded
    (jsmall,), (tsmall,) = (list(d.subset(np.arange(3)).iter_batches(8)) for d in (jds, tds))
    np.testing.assert_array_equal(tsmall.xyz.numpy(), jsmall.xyz)


# --------------------------------------------------------------------- CLI
CLI_ARGS = ["-n_cgs", "4", "-num_features", "8", "-n_rbf", "3", "-enc_nconv", "1",
            "-dec_nconv", "1", "-ndata", "24", "-nepochs", "2", "-batch_size", "4",
            "-gamma", "5", "-zeta", "10", "-zeta_warmup", "4", "--graph_grad", "-graph_warmup",
            "4", "--h_project", "--sample_hard"]


def _table(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, list(reader)


def test_cli_writes_the_jax_files_and_columns(tmp_path, monkeypatch, frames):
    """One run of each CLI on the same arguments and data: the same files
    (``params.msgpack`` in JAX's tree too), headers and row counts, the
    JAX flags in modelparams.json plus ``device``, finite rows."""
    z, xyz, bonds = frames
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, xyz, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    jrows = jcli.main(CLI_ARGS + ["-logdir", str(tmp_path / "jax" / "run")])
    trows = run_diffpool.main(CLI_ARGS + ["-logdir", str(tmp_path / "port" / "run"),
                                          "--device", "cpu"])
    assert len(trows) == len(jrows) == 2 and list(trows[0]) == list(jrows[0])
    (jrun,), (trun,) = (list((tmp_path / k).iterdir()) for k in ("jax", "port"))
    assert jrun.name == trun.name
    files = {p.relative_to(jrun).as_posix() for p in jrun.rglob("*") if p.is_file()}
    assert files == {p.relative_to(trun).as_posix() for p in trun.rglob("*") if p.is_file()}
    for name in ("cv_stats.csv", "fold0/train_log.csv", "fold1/train_log.csv"):
        (jh, jr), (th, tr) = _table(jrun / name), _table(trun / name)
        assert th == jh and len(tr) == len(jr), name
        assert all(np.isfinite(float(v)) for row in tr for v in row.values()), name
    assert "test_steric" in _table(trun / "cv_stats.csv")[0]
    jp = json.loads((jrun / "modelparams.json").read_text())
    tp = json.loads((trun / "modelparams.json").read_text())
    assert {k: v for k, v in tp.items() if k not in ("device", "logdir")} == \
        {k: v for k, v in jp.items() if k != "logdir"} and tp["device"] == "cpu"
    samples = np.load(trun / "fold0" / "test_samples.npy")
    assert samples.shape == np.load(jrun / "fold0" / "test_samples.npy").shape == (8, N_ATOMS, 3)
    cfg = DiffPoolConfig(n_atoms=N_ATOMS, n_cgs=4, feat_dim=8, n_rbf=3, enc_nconv=1,
                         dec_nconv=1)
    state = load_params(str(trun / "fold0" / "params.msgpack"), cfg)
    assert set(state) == set(DiffPoolVAE(cfg).state_dict())
