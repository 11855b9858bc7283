"""Serving: the port's Backmapper against the JAX Backmapper on the same
converted parameters and the same prior noise."""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import ExperimentConfig, ModelConfig
from coarsegrainingvae_tpu.data.mappings import newman_mapping
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.serve import Backmapper as JaxBackmapper
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE as TorchModel
from coarsegrainingvae_tpu_torch.serve import Backmapper

torch.set_num_threads(1)

M, F = 3, 24
TOL = dict(rtol=1e-4, atol=1e-5)   # f32, as tests/test_pallas_pseudo.py:74-76


@pytest.fixture(scope="module")
def served():
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=4, seed=0)
    mapping = newman_mapping(bonds, z.shape[0], M, seed=0)
    cfg = ExperimentConfig(model=ModelConfig(
        n_cgs=M, n_basis=F, n_rbf=5, atom_cutoff=8.5, cg_cutoff=9.5, enc_nconv=2,
        dec_nconv=2, activation="swish", dec_type="pseudo", breaksym=True,
        compute_dtype="float32"))
    jmodel = JaxModel(cfg=cfg.model)
    # the JAX Backmapper builds CG-only batches; one of them initialises
    batch = JaxBackmapper(jmodel, None, mapping, z, cfg)._make_batch(
        np.stack([frames[0, mapping == k].mean(0) for k in range(M)]))
    params = jax.device_get(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, batch
    )["params"])
    port_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    tmodel = TorchModel(port_cfg.model)
    tmodel.load_state_dict(convert_flax_params(params, port_cfg.model))
    cg = np.stack([frames[:, mapping == k].mean(1) for k in range(M)], 1)
    return dict(jax=JaxBackmapper(jmodel, params, mapping, z, cfg),
                port=Backmapper(tmodel, mapping, z, port_cfg, device="cpu"),
                cg=cg, mapping=mapping, n_atoms=z.shape[0], cfg=port_cfg)


def _patch_eps(mp, n_samples, seed=5):
    eps = np.random.default_rng(seed).normal(size=(n_samples, M, F)).astype(np.float32)
    mp.setattr(jax.random, "normal",
               lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
    mp.setattr(torch, "randn", lambda shape, generator=None, device=None, dtype=None:
               torch.as_tensor(eps, device=device, dtype=dtype))


@pytest.mark.parametrize("frames,n_samples", [(0, 4), (slice(0, 3), 2)])
def test_backmap_matches_jax(served, frames, n_samples, monkeypatch):
    cg = served["cg"][frames]
    with monkeypatch.context() as mp:
        _patch_eps(mp, n_samples)
        ref = served["jax"].backmap(cg, n_samples=n_samples, seed=1)
        out = served["port"].backmap(cg, n_samples=n_samples, seed=1)
    n_frames = 1 if cg.ndim == 2 else cg.shape[0]
    want = (n_samples, served["n_atoms"], 3)
    assert out.shape == (want if cg.ndim == 2 else (n_frames,) + want)
    np.testing.assert_allclose(out, ref, **TOL)


def test_backmap_is_a_seeded_ensemble_on_the_cg_frame(served):
    bm, cg, mapping = served["port"], served["cg"][1], served["mapping"]
    ens = bm.backmap(cg, n_samples=4, seed=1)
    assert ens.shape == (4, served["n_atoms"], 3) and np.isfinite(ens).all()
    # centre-of-mass constraint: each bead is the mean of its atoms
    for k in range(M):
        np.testing.assert_allclose(ens[:, mapping == k].mean(1),
                                   np.broadcast_to(cg[k], (4, 3)), atol=1e-3)
    assert np.abs(ens[0] - ens[1]).max() > 1e-5             # samples differ
    np.testing.assert_array_equal(ens, bm.backmap(cg, n_samples=4, seed=1))
    assert np.abs(ens - bm.backmap(cg, n_samples=4, seed=2)).max() > 1e-5


def test_unported_serving_paths_raise(served, tmp_path, monkeypatch):
    """from_run serves a fold's checkpoint (a fold without one raises): the
    dense model's, and with sparse=True the sparse CGequiVAE's, each equal
    to the in-memory model it saved."""
    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    port = served["port"]
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    save_npz_traj(str(tmp_path / "dipeptide.npz"), port.z,
                  np.zeros((8, served["n_atoms"], 3)), np.zeros((0, 2)))
    served["cfg"].save(str(tmp_path / "modelparams.json"))
    for name, model, sparse in (
            ("fold0", port.model, False),
            ("fold1", CGequiVAE(served["cfg"].model, generator=torch.Generator().manual_seed(3)),
             True)):
        fold = tmp_path / name
        fold.mkdir()
        (fold / "mapping.json").write_text(json.dumps([int(k) for k in served["mapping"]]))
        if not sparse:
            with pytest.raises(FileNotFoundError, match="no checkpoints"):
                Backmapper.from_run(str(tmp_path / "modelparams.json"), str(fold), device="cpu")
        ref = Backmapper(model, served["mapping"], port.z, served["cfg"], device="cpu")
        state = Trainer(model, served["cfg"], device="cpu").init_state(
            ref._make_batch(served["cg"][0]))
        CheckpointManager(str(fold / "ckpt")).save(0, state)
        bm = Backmapper.from_run(str(tmp_path / "modelparams.json"), str(fold), sparse=sparse,
                                 device="cpu")
        assert type(bm.model) is type(model)
        np.testing.assert_array_equal(bm.backmap(served["cg"][:2], n_samples=3, seed=2),
                                      ref.backmap(served["cg"][:2], n_samples=3, seed=2))


def test_projection_without_bonds_warns_and_serves_raw(served):
    """h_project_eval without bonds/ref_xyz warns, as the JAX Backmapper
    does, and serves the decoder's raw hydrogens; with them the hydrogens
    move (parity with the JAX package: tests/test_torch_steric.py)."""
    from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide as jax_peptide

    cfg = served["cfg"]
    proj = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, h_project_eval=True))
    port = served["port"]
    with pytest.warns(RuntimeWarning, match="RAW"):
        raw = Backmapper(port.model, served["mapping"], port.z, proj, device="cpu")
    np.testing.assert_array_equal(raw.backmap(served["cg"][0], n_samples=2, seed=1),
                                  port.backmap(served["cg"][0], n_samples=2, seed=1))
    _, frames, bonds = jax_peptide("dipeptide", n_frames=1, seed=0)
    bm = Backmapper(port.model, served["mapping"], port.z, proj, device="cpu", bonds=bonds,
                    ref_xyz=frames[0])
    moved = np.abs(bm.backmap(served["cg"][0], n_samples=2, seed=1)
                   - raw.backmap(served["cg"][0], n_samples=2, seed=1)).max(axis=(0, 2))
    h = port.z == 1
    assert moved[h].max() > 1e-3 and moved[~h].max() == 0.0


def test_sparse_backmap_matches_jax(served, monkeypatch):
    """The sparse CGequiVAE served through both Backmappers (each builds
    the CG radius graph of its requests) on converted parameters and the
    same prior noise."""
    from coarsegrainingvae_tpu.models.cgvae import CGequiVAE as JaxSparse
    from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE

    jbm = served["jax"]
    cfg = dataclasses.replace(jbm.cfg, model=dataclasses.replace(jbm.cfg.model, sparse=True))
    jmodel = JaxSparse(cfg=cfg.model)
    batch = JaxBackmapper(jmodel, None, served["mapping"], jbm.z, cfg)._make_batch(
        served["cg"][0])
    params = jax.device_get(jax.jit(jmodel.init)(
        {"params": jax.random.PRNGKey(2), "sample": jax.random.PRNGKey(3)}, batch)["params"])
    port_cfg = tcfg.ExperimentConfig.from_json(cfg.to_json())
    tmodel = CGequiVAE(port_cfg.model)
    tmodel.load_state_dict(convert_flax_params(params, port_cfg.model))
    n_samples = 3
    eps = np.random.default_rng(6).normal(size=(n_samples * M, F)).astype(np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype).reshape(shape))
        mp.setattr(torch, "randn", lambda shape, generator=None, device=None, dtype=None:
                   torch.as_tensor(eps, device=device, dtype=dtype).reshape(shape))
        ref = JaxBackmapper(jmodel, params, served["mapping"], jbm.z, cfg).backmap(
            served["cg"][:2], n_samples=n_samples, seed=1)
        out = Backmapper(tmodel, served["mapping"], jbm.z, port_cfg, device="cpu").backmap(
            served["cg"][:2], n_samples=n_samples, seed=1)
    np.testing.assert_allclose(out, ref, **TOL)


def test_backmapper_defaults_to_the_card(served):
    """Backmapper runs on the card unless the caller passes device="cpu";
    with no card its default raises instead of quietly serving on the
    CPU."""
    import inspect

    assert inspect.signature(Backmapper).parameters["device"].default == "cuda"
    cfg = served["cfg"]
    model = TorchModel(cfg.model)
    if torch.cuda.is_available():
        bm = Backmapper(model, served["mapping"], np.ones(served["n_atoms"]), cfg)
        assert bm.device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Backmapper(model, served["mapping"], np.ones(served["n_atoms"]), cfg)
    assert next(model.parameters()).device.type == "cpu"
