"""The steric recipes in the PyTorch port against the JAX package: the
excluded-volume tables and loss, the H bond-length projection (in the
dense model, in ``Trainer.reconstruct`` / ``generate`` and in
``Backmapper.backmap``), and the committed ``steric_ab`` recipes.

Both packages run on the CPU at f32 on the same arrays and converted
parameters; the JAX models are jitted with their default einsum/stacked
formulations. Tolerance rtol 1e-4 / atol 1e-5 (the same arithmetic summed
in another order) unless a test says otherwise.
"""
import dataclasses
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, TrainConfig
from coarsegrainingvae_tpu.models import cgvae as jcgvae
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh
from coarsegrainingvae_tpu.serve import Backmapper as JaxBackmapper
from coarsegrainingvae_tpu.train import losses as jlosses
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.models import cgvae
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.serve import Backmapper
from coarsegrainingvae_tpu_torch.train import losses
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH = 4
RECIPES = pathlib.Path(__file__).resolve().parents[1] / "examples" / "results" / "steric_ab"


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


def _topology():
    from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide

    return synthetic_peptide("dipeptide", n_frames=6, seed=7)


# -------------------------------------------------------------- the tables
@pytest.mark.parametrize("with_frames", [False, True])
def test_steric_tables_match_jax(with_frames):
    z, frames, bonds = _topology()
    z = np.concatenate([z, [0]])                     # one padding atom
    frames = np.concatenate([frames, np.zeros((len(frames), 1, 3), np.float32)], 1)
    kw = dict(margin=0.25, frames=frames if with_frames else None)
    want = jlosses.build_steric_tables(z, bonds, **kw)
    got = losses.build_steric_tables(z, bonds, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_steric_loss_and_gradient_match_jax():
    z, frames, bonds = _topology()
    thresh, mask = jlosses.build_steric_tables(z, bonds, frames=frames)
    # squeeze the frames so many nonbonded pairs violate their threshold
    xyz = (frames[:3] * 0.6).reshape(-1, 3).astype(np.float32)
    f = jax.value_and_grad(lambda x: jlosses.steric_loss(x, jnp.asarray(thresh),
                                                         jnp.asarray(mask)))
    want, want_g = f(jnp.asarray(xyz))
    x = torch.as_tensor(xyz).requires_grad_(True)
    got = losses.steric_loss(x, torch.as_tensor(thresh), torch.as_tensor(mask))
    got.backward()
    assert float(want) > 0.0
    np.testing.assert_allclose(float(got.detach()), float(want), **TOL)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_g), **TOL)


def test_vae_loss_steric_term_matches_jax():
    """zeta as a number and as a tensor (the warm-up ramp's weight): the
    total and every metric, "steric" among them."""
    z, frames, bonds = _topology()
    n = z.shape[0]
    tables = jlosses.build_steric_tables(z, bonds)
    rng = np.random.default_rng(0)
    b, m, f = 2, 3, 4
    out = dict(mu=rng.normal(size=(b * m, f)), sigma=np.abs(rng.normal(size=(b * m, f))) + 0.1,
               prior_mu=rng.normal(size=(b * m, f)),
               prior_sigma=np.abs(rng.normal(size=(b * m, f))) + 0.1,
               xyz=frames[:b].reshape(-1, 3), xyz_recon=(frames[:b] * 0.7).reshape(-1, 3))
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    flat = dict(z=np.tile(z, b), atom_mask=np.ones(b * n, bool), cg_mask=np.ones(b * m, bool),
                bonds=(bonds[None] + n * np.arange(b)[:, None, None]).reshape(-1, 2),
                bond_mask=np.ones(b * len(bonds), bool))

    class _G:
        pass

    jg = _G()
    for k, v in flat.items():
        setattr(jg, k, jnp.asarray(v))
    tg = cgvae.FlatGraph(xyz=torch.as_tensor(out["xyz"]), **{
        k: torch.as_tensor(v).long() if v.dtype.kind == "i" else torch.as_tensor(v)
        for k, v in flat.items()})
    for zeta in (7.0, torch.tensor(3.5)):
        jz = zeta if isinstance(zeta, float) else jnp.asarray(float(zeta))
        jtotal, jm = jlosses.vae_loss(
            jcgvae.VAEOutput(**{k: jnp.asarray(v) for k, v in out.items()}), jg,
            0.05, 25.0, zeta=jz, steric=tuple(map(jnp.asarray, tables)))
        ttotal, tm = losses.vae_loss(
            cgvae.VAEOutput(**{k: torch.as_tensor(v) for k, v in out.items()}), tg,
            0.05, 25.0, zeta=zeta, steric=tuple(map(torch.as_tensor, tables)))
        assert set(tm) == set(jm) and "steric" in tm and float(tm["steric"]) > 0.0
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


# ------------------------------------------------------- the H projection
def test_project_h_bonds_matches_jax_with_duplicate_edges():
    """Directed duplicates of every covalent edge and the 1-3 pairs of the
    graph-loss expansion: each H snaps to its nearest heavy partner at the
    true length; the gradient through the projection matches too."""
    from coarsegrainingvae_tpu.data.topology import high_order_edges

    z, frames, bonds = _topology()
    n = z.shape[0]
    hyper = high_order_edges(np.asarray(bonds, np.int64), 2, n)
    directed = np.concatenate([hyper, hyper[:, ::-1], bonds[::-1]], 0)   # duplicates
    b = 3
    edges = (directed[None] + n * np.arange(b)[:, None, None]).reshape(-1, 2)
    mask = np.ones(len(edges), bool)
    mask[::7] = False
    zz = np.tile(z, b)
    true = frames[:b].reshape(-1, 3).astype(np.float32)
    recon = (true + np.random.default_rng(1).normal(size=true.shape) * 0.3).astype(np.float32)
    ct = np.random.default_rng(2).normal(size=true.shape).astype(np.float32)

    def jproj(x):
        return jcgvae.project_h_bonds(x, jnp.asarray(zz), jnp.asarray(true),
                                      jnp.asarray(edges), jnp.asarray(mask))

    want = np.asarray(jproj(jnp.asarray(recon)))
    want_g = np.asarray(jax.grad(lambda x: jnp.sum(jproj(x) * ct))(jnp.asarray(recon)))
    x = torch.as_tensor(recon).requires_grad_(True)
    got = cgvae.project_h_bonds(x, torch.as_tensor(zz).long(), torch.as_tensor(true),
                                torch.as_tensor(edges).long(), torch.as_tensor(mask))
    (got * torch.as_tensor(ct)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(x.grad.numpy(), want_g, **TOL)
    h = zz == 1
    assert np.abs(want[h] - recon[h]).max() > 1e-3          # hydrogens moved
    np.testing.assert_array_equal(got.detach().numpy()[~h], recon[~h])   # heavy atoms kept
    # the duplicates' order does not change a bit
    perm = np.random.default_rng(3).permutation(len(edges))
    again = cgvae.project_h_bonds(torch.as_tensor(recon), torch.as_tensor(zz).long(),
                                  torch.as_tensor(true), torch.as_tensor(edges[perm]).long(),
                                  torch.as_tensor(mask[perm]))
    assert torch.equal(again, got.detach())


def _dense_pair(tiny_model_cfg, jds, **model_kw):
    cfg = ExperimentConfig(
        model=dataclasses.replace(tiny_model_cfg, n_basis=16, det=True,
                                  compute_dtype="float32", **model_kw),
        data=DataConfig(batch_size=BATCH, seed=0),
        train=TrainConfig(lr=1e-3, beta=0.05, gamma=25.0, adam_moment_dtype="float32"))
    jtr = JaxTrainer(JaxModel(cfg=cfg.model), cfg, mesh=make_mesh(1))
    jstate = jtr.init_state(jds.batch(np.arange(BATCH)), seed=0)
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    model = DenseCGVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    return jtr, jstate, Trainer(model, tc, device="cpu")


def test_h_project_in_the_dense_forward_matches_jax(small_dataset, tiny_model_cfg):
    jtr, jstate, tr = _dense_pair(tiny_model_cfg, small_dataset, h_project=True)
    idx = np.arange(BATCH)
    ref = jax.jit(lambda p, b: jtr.model.apply({"params": p}, b, rngs={
        "sample": jax.random.PRNGKey(0)}))(jstate.params, small_dataset.batch(idx))
    with torch.no_grad():
        out = tr.model(_port_dataset(small_dataset).batch(idx))
    np.testing.assert_allclose(out.xyz_recon.numpy(), np.asarray(ref.xyz_recon), **TOL)


def test_h_project_eval_in_reconstruct_and_generate(small_dataset, tiny_model_cfg,
                                                    monkeypatch):
    """Trainer.reconstruct and Trainer.generate project (h_project_eval)
    as the JAX Trainer's do; the forward the loss sees does not."""
    jtr, jstate, tr = _dense_pair(tiny_model_cfg, small_dataset, h_project_eval=True)
    idx = np.arange(BATCH)
    jb, tb = small_dataset.batch(idx), _port_dataset(small_dataset).batch(idx)
    rng = jax.random.PRNGKey(0)
    np.testing.assert_allclose(tr.reconstruct(tb).numpy(),
                               np.asarray(jtr.reconstruct(jstate.params, jb, rng)), **TOL)
    with torch.no_grad():
        raw = tr.model(tb).xyz_recon
    assert np.abs(raw.numpy() - tr.reconstruct(tb).numpy()).max() > 1e-3
    eps = np.random.default_rng(4).normal(size=(BATCH, 3, 16)).astype(np.float32)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
        mp.setattr(torch, "randn", lambda shape, generator=None, device=None, dtype=None:
                   torch.as_tensor(eps, device=device, dtype=dtype).reshape(shape))
        want = np.asarray(jtr.generate(jstate.params, jb, rng))
        got = tr.generate(tb).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_backmap_with_h_project_eval_matches_jax(small_dataset, tiny_model_cfg, monkeypatch):
    """Backmapper(bonds=, ref_xyz=) projects the served ensembles as the JAX
    Backmapper does; without them both serve raw hydrogens and warn."""
    from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=4, seed=7)
    mapping = np.asarray(small_dataset.mapping)
    jtr, jstate, tr = _dense_pair(tiny_model_cfg, small_dataset, h_project_eval=True)
    cg = np.stack([frames[:, mapping == k].mean(1) for k in range(3)], 1)
    n_samples = 3
    eps = np.random.default_rng(5).normal(size=(n_samples, 3, 16)).astype(np.float32)
    jbm = JaxBackmapper(jtr.model, jstate.params, mapping, z, jtr.cfg, bonds=bonds,
                        ref_xyz=frames[0])
    bm = Backmapper(tr.model, mapping, z, tr.cfg, device="cpu", bonds=bonds, ref_xyz=frames[0])
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
        mp.setattr(torch, "randn", lambda shape, generator=None, device=None, dtype=None:
                   torch.as_tensor(eps, device=device, dtype=dtype).reshape(shape))
        want = jbm.backmap(cg[:2], n_samples=n_samples, seed=1)
        got = bm.backmap(cg[:2], n_samples=n_samples, seed=1)
        with pytest.warns(RuntimeWarning, match="RAW"):
            raw = Backmapper(tr.model, mapping, z, tr.cfg, device="cpu")
        raw_out = raw.backmap(cg[:2], n_samples=n_samples, seed=1)
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got - raw_out).max() > 1e-3


# ------------------------------------------------------------ the recipes
@pytest.mark.parametrize("name,batch", [("dip_full_z100", 2), ("dip_full_c6_hprojecteval", 2),
                                        ("chig_full_z200w", 1)])
def test_steric_ab_recipes_build_and_step_on_the_cpu(name, batch):
    """The committed recipes at their full width: the steric tables (with
    frames where the recipe asks), a trainer, and one train step on their
    synthetic molecule, whose loss carries the steric term."""
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model

    cfg = tcfg.ExperimentConfig.load(str(RECIPES / f"{name}_modelparams.json"))
    assert cfg.train.zeta > 0 and cfg.model.n_basis == 600
    c = cfg.model
    z, frames, bonds = synthetic_peptide(cfg.data.dataset, n_frames=batch + 1, seed=0,
                                         device="cpu")
    mapping = newman_mapping(bonds, z.shape[0], c.n_cgs, seed=0)
    ds = build_dataset(mapping, frames, c.atom_cutoff, c.cg_cutoff, z, bonds,
                       order=cfg.data.edgeorder)
    tables = losses.build_steric_tables(
        z, bonds, margin=cfg.train.steric_margin,
        frames=frames if cfg.train.steric_data_margin else None)
    cfg = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, batch_size=batch))
    tr = Trainer(build_flagship_model(c, generator=torch.Generator().manual_seed(0)), cfg,
                 device="cpu", steric_tables=tables)
    state = tr.init_state(ds.batch(np.arange(batch)))
    with torch.no_grad():
        state.step.fill_(cfg.train.zeta_warmup)           # past the ramp
    state, m = tr.train_step(state, ds.batch(np.arange(batch)),
                             torch.Generator().manual_seed(1))
    assert set(m) >= {"loss", "recon", "kl", "graph", "steric", "skipped"}
    assert all(np.isfinite(float(v)) for v in m.values())
    assert int(state.step) == cfg.train.zeta_warmup + 1
    with torch.no_grad():
        xyz = tr.reconstruct(ds.batch(np.arange(batch)))
    assert xyz.shape == (batch * z.shape[0], 3) and torch.isfinite(xyz).all()
    assert json.loads(cfg.to_json())["model"]["h_project_eval"] == c.h_project_eval
