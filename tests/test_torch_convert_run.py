"""Folds moved between the JAX package and the port by
``scripts/convert_run.py``, on the CPU.

One tiny fold is trained by JAX's ``run_cgvae.run_cv`` and one by the
port's (module fixtures, f32 compute, ``det=True`` so the train step draws
nothing; bf16 Adam moments, the default). Serving draws from the prior:
both packages get the same injected draw. The JAX fold
goes ``--to torch`` and the port fold ``--to jax``; the converted fold is
then read by the other package: ``Backmapper.from_run`` against the
original package's, the port's ``postanalysis.reevaluate``, and one train
step from the converted state against JAX's step from the orbax state.
"""
import importlib.util
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu import config as jcfg
from coarsegrainingvae_tpu.cli import run_cgvae as jrun
from coarsegrainingvae_tpu.data.dataset import build_dataset as jbuild
from coarsegrainingvae_tpu.models.cgvae import build_flagship_model as jbuild_model
from coarsegrainingvae_tpu.serve import Backmapper as JaxBackmapper
from coarsegrainingvae_tpu.train.checkpoint import CheckpointManager as JaxCkpt
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.cli import postanalysis
from coarsegrainingvae_tpu_torch.cli import run_cgvae as trun
from coarsegrainingvae_tpu_torch.data.dataset import build_dataset as tbuild
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
from coarsegrainingvae_tpu_torch.serve import Backmapper
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-4, atol=1e-5)
N_FRAMES = 32

_spec = importlib.util.spec_from_file_location(
    "convert_run", Path(__file__).resolve().parents[1] / "scripts" / "convert_run.py")
convert_run = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(convert_run)


def _cfg(logdir: str) -> jcfg.ExperimentConfig:
    return jcfg.ExperimentConfig(
        model=jcfg.ModelConfig(n_cgs=3, n_basis=16, n_rbf=4, enc_nconv=1, dec_nconv=2,
                               dec_type="pseudo", det=True, compute_dtype="float32"),
        data=jcfg.DataConfig(dataset="dipeptide", ndata=N_FRAMES, batch_size=8, nsplits=2),
        train=jcfg.TrainConfig(nepochs=2, lr=1e-3, beta=0.05, gamma=1.0),
        logdir=logdir)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    """The frames both packages read (COARSEGRAININGVAE_DATA)."""
    d = tmp_path_factory.mktemp("data")
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=N_FRAMES, seed=0, device="cpu")
    save_npz_traj(str(d / "dipeptide.npz"), z, frames, bonds)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COARSEGRAININGVAE_DATA", str(d))
        yield d


@pytest.fixture(scope="module")
def jax_run(data_dir, tmp_path_factory):
    run = tmp_path_factory.mktemp("jax") / "run"
    jrun.run_cv(_cfg(str(run)), n_ensemble=1, nevals=1, max_folds=1)
    return run


@pytest.fixture(scope="module")
def port_run(data_dir, tmp_path_factory):
    run = tmp_path_factory.mktemp("port") / "run"
    cfg = tcfg.ExperimentConfig.from_json(_cfg(str(run)).to_json())
    trun.run_cv(cfg, n_ensemble=1, nevals=1, max_folds=1, device="cpu")
    return run


def _copy(run: Path, dst: Path) -> Path:
    shutil.copytree(run, dst)
    return dst / "fold0"


def _cg(bm, mapping):
    rng = np.random.default_rng(0)
    xyz = bm.ref_xyz[None] + rng.normal(size=(2,) + bm.ref_xyz.shape).astype(np.float32) * 0.2
    return np.stack([xyz[:, mapping == k].mean(1) for k in range(3)], 1)


def _eps(shape) -> np.ndarray:
    return np.random.default_rng(1).normal(size=tuple(shape)).astype(np.float32)


@pytest.fixture
def injected(monkeypatch):
    """The prior draw of generate, the same array in both packages."""
    from coarsegrainingvae_tpu_torch.models import dense_cgvae

    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(_eps(shape), dtype))
    monkeypatch.setattr(dense_cgvae, "draw_eps", lambda like, generator, eps:
                        torch.as_tensor(_eps(like.shape)).to(like))


def _served(fold: Path, jax_side: bool):
    mp = str(fold.parent / "modelparams.json")
    bm = (JaxBackmapper.from_run(mp, str(fold)) if jax_side
          else Backmapper.from_run(mp, str(fold), device="cpu"))
    mapping = np.asarray(json.loads((fold / "mapping.json").read_text()))
    return np.asarray(bm.backmap(_cg(bm, mapping), n_samples=2, seed=0))


def _files(fold: Path) -> dict:
    return {p.name: p.read_bytes() for p in fold.iterdir() if p.is_file()}


@pytest.fixture(scope="module")
def jax_to_torch(jax_run, tmp_path_factory):
    """(the untouched JAX fold, the same fold converted --to torch)."""
    base = tmp_path_factory.mktemp("j2t")
    original, converted = _copy(jax_run, base / "orig"), _copy(jax_run, base / "conv")
    before = _files(converted)
    assert convert_run.main(["--to", "torch", str(converted.parent)]) == 0
    assert _files(converted) == before                 # mapping.json, the CSVs, the xyz
    assert (converted.parent / "modelparams.json").read_bytes() == \
        (jax_run / "modelparams.json").read_bytes()
    assert (converted / "ckpt_jax").is_dir()
    return original, converted


def test_jax_fold_refused_until_converted(jax_run, tmp_path):
    from coarsegrainingvae_tpu_torch.train.checkpoint import OrbaxCheckpointError

    fold = _copy(jax_run, tmp_path / "run")
    with pytest.raises(OrbaxCheckpointError, match="convert_run.py --to torch"):
        Backmapper.from_run(str(fold.parent / "modelparams.json"), str(fold), device="cpu")


def test_converted_jax_fold_serves_what_jax_serves(jax_to_torch, injected):
    original, converted = jax_to_torch
    got, want = _served(converted, jax_side=False), _served(original, jax_side=True)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **F32_TOL)


def test_converted_jax_fold_reevaluates(jax_to_torch):
    _, converted = jax_to_torch
    out = postanalysis.reevaluate(str(converted.parent / "modelparams.json"), str(converted),
                                  graph_eval=False, n_ensemble=2, nevals=2, device="cpu")
    assert np.isfinite(out["all_atom_rmsd"]) and len(out["tica_gen"]) == 4


def test_a_step_from_the_converted_state_matches_jax(jax_to_torch):
    """One train step from the converted checkpoint against JAX's step from
    the orbax one, on the same batch: params at 1e-4 of each tensor's
    largest entry plus 2e-5 (as tests/test_torch_train.py's trajectory),
    the bf16 moments at 2^-7 of it plus 1e-5, count and step exactly."""
    original, converted = jax_to_torch
    mp = str(original.parent / "modelparams.json")
    jc = jcfg.ExperimentConfig.load(mp)
    mapping = np.asarray(json.loads((original / "mapping.json").read_text()), np.int32)
    from coarsegrainingvae_tpu.data.proteins import load_frames

    z, frames, bonds = load_frames("dipeptide", N_FRAMES, seed=jc.data.seed)
    jds = jbuild(mapping, frames, 8.5, 9.5, z, bonds, order=2, rotate=False, seed=0)
    tds = tbuild(mapping, frames, 8.5, 9.5, z, bonds, order=2, rotate=False, seed=0)
    idx = np.arange(8)
    jtr = JaxTrainer(jbuild_model(jc.model), jc)
    jstate, _, jstep = JaxCkpt(str(original / "ckpt")).restore(jtr.init_state(jds.batch(idx)))
    tc = tcfg.ExperimentConfig.load(mp)
    tr = Trainer(build_flagship_model(tc.model), tc, device="cpu")
    state, _, step = CheckpointManager(str(converted / "ckpt")).restore(
        tr.init_state(tds.batch(idx)))
    assert step == jstep and int(state.step) == int(jstate.step)
    jstate, _ = jtr.train_step(jstate, jds.batch(idx), jax.random.PRNGKey(0))
    state, _ = tr.train_step(state, tds.batch(idx))
    from coarsegrainingvae_tpu_torch.convert import train_state_to_flax
    from coarsegrainingvae_tpu_torch.train.checkpoint import _payload

    got = train_state_to_flax(_payload(state), tc)
    want = jax.device_get(jstate)
    assert int(got["step"]) == int(want.step) and \
        int(got["opt_state"]["1"]["count"]) == int(want.opt_state[1].count)
    pairs = [("params", got["params"], want.params, 1e-4),
             ("mu", got["opt_state"]["1"]["mu"], want.opt_state[1].mu, 2.0 ** -7),
             ("nu", got["opt_state"]["1"]["nu"], want.opt_state[1].nu, 2.0 ** -7)]
    for part, g_tree, w_tree, rel in pairs:
        g_leaves = dict(jax.tree_util.tree_leaves_with_path(g_tree))
        w_leaves = dict(jax.tree_util.tree_leaves_with_path(dict(w_tree)))
        assert len(g_leaves) == len(w_leaves)
        for path, w in w_leaves.items():
            g = g_leaves[path]
            g = g.float().numpy() if isinstance(g, torch.Tensor) else np.asarray(g, np.float32)
            w = np.asarray(w, np.float32)
            atol = (2e-5 if part == "params" else 1e-5) + rel * np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, atol=atol, err_msg=f"{part} {path}")


def test_port_fold_to_jax_serves_what_the_port_serves(port_run, tmp_path, injected):
    fold = _copy(port_run, tmp_path / "run")
    want = _served(fold, jax_side=False)
    assert convert_run.main(["--to", "jax", str(fold)]) == 0
    assert (fold / "ckpt_torch").is_dir()
    meta = json.loads(next((fold / "ckpt").glob("meta_*.json")).read_text())
    assert [h["epoch"] for h in meta["history"]] == [0, 1]
    got = _served(fold, jax_side=True)
    np.testing.assert_allclose(got, want, **F32_TOL)
    # and the port refuses it now, naming the way back
    with pytest.raises(ValueError, match="convert_run.py"):
        CheckpointManager(str(fold / "ckpt")).read()


def test_round_trip_through_orbax_is_exact(port_run, tmp_path):
    """port -> orbax -> port gives the port's checkpoint back bit for bit."""
    fold = _copy(port_run, tmp_path / "run")
    before, meta, step = CheckpointManager(str(fold / "ckpt")).read()
    convert_run.main(["--to", "jax", str(fold)])
    shutil.rmtree(fold / "ckpt_torch")
    convert_run.main(["--to", "torch", str(fold)])
    after, meta2, step2 = CheckpointManager(str(fold / "ckpt")).read()
    assert (step2, meta2) == (step, meta)
    assert list(after["params"]) == list(before["params"])
    for k in before["params"]:
        assert torch.equal(after["params"][k], before["params"][k]), k
    for k in ("count", "mu", "nu"):
        a, b = after["opt_state"][k], before["opt_state"][k]
        assert a.dtype == b.dtype and torch.equal(a, b), k
    assert torch.equal(after["step"], before["step"]) and torch.equal(after["lr"], before["lr"])


def test_converter_refuses_the_wrong_direction(port_run, tmp_path):
    fold = _copy(port_run, tmp_path / "run")
    with pytest.raises(ValueError, match="--to torch converts the other kind"):
        convert_run.main(["--to", "torch", str(fold)])
