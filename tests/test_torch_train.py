"""Training in the PyTorch port against the JAX package: losses, the
optimiser, one step's gradients of the whole model, a 20-step trajectory,
the skip-batch guard and ``fit``.

Both packages run on the CPU on the same batches and the same converted
parameters, at f32 and with ``det=True`` (no sampling noise). The JAX side
is jitted; with ``"pallas"`` impls it runs its Pallas kernels, forward and
backward, in interpret mode. The port runs its kernels' plain versions and
their plain VJPs (the tensors are on the CPU).
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, TrainConfig
from coarsegrainingvae_tpu.models.cgvae import VAEOutput as JaxOutput
from coarsegrainingvae_tpu.models.cgvae import flatten_batch as jax_flatten
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh
from coarsegrainingvae_tpu.train import losses as jlosses
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu.train.trainer import make_optimizer as jax_make_optimizer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.models.cgvae import VAEOutput, flatten_batch
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.train import losses
from coarsegrainingvae_tpu_torch.train.trainer import Trainer, flatten, make_optimizer

torch.set_num_threads(1)

BATCH = 8
# f32, the same arithmetic in another order (XLA vs torch reductions and
# matmuls): the tolerance of tests/test_pallas_pseudo.py:100
TOL = dict(rtol=2e-4, atol=2e-5)


def _exp(model_cfg, **train_kw) -> ExperimentConfig:
    train = dict(lr=1e-3, beta=0.05, gamma=1.0, grad_clip=0.01,
                 adam_moment_dtype="float32")
    train.update(train_kw)
    return ExperimentConfig(model=model_cfg, data=DataConfig(batch_size=BATCH, seed=0),
                            train=TrainConfig(**train))


def _torch_cfg(cfg: ExperimentConfig) -> tcfg.ExperimentConfig:
    return tcfg.ExperimentConfig.from_json(cfg.to_json())


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


def _models(cfg: ExperimentConfig, jds):
    """JAX trainer and initial params; the port's trainer on the same
    parameters."""
    jtr = JaxTrainer(JaxModel(cfg=cfg.model), cfg, mesh=make_mesh(1))
    jstate = jtr.init_state(jds.batch(np.arange(BATCH)), seed=0)
    tc = _torch_cfg(cfg)
    model = DenseCGVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    return jtr, jstate, Trainer(model, tc, device="cpu")


def _model_cfg(tiny_model_cfg, impl):
    kw = dict(message_impl="pallas", pseudo_impl="pallas") if impl == "pallas" else {}
    return dataclasses.replace(tiny_model_cfg, det=True, compute_dtype="float32", **kw)


# ------------------------------------------------------------------ losses
def _random_outputs(seed=0, b=2, n=5, m=3, f=4):
    rng = np.random.default_rng(seed)

    def arr(*shape, pos=False):
        a = rng.normal(size=shape).astype(np.float32)
        return np.abs(a) + 0.1 if pos else a

    out = dict(mu=arr(b * m, f), sigma=arr(b * m, f, pos=True),
               prior_mu=arr(b * m, f), prior_sigma=arr(b * m, f, pos=True),
               xyz=arr(b * n, 3), xyz_recon=arr(b * n, 3))
    z = np.array([[6, 1, 8, 1, 0], [7, 6, 1, 1, 1]], np.int32)
    bonds = np.array([[[0, 1], [0, 2], [2, 3]], [[0, 1], [1, 2], [3, 4]]], np.int32)
    atom_mask = z > 0
    cg_mask = np.array([[True, True, False], [True, True, True]])
    bond_mask = np.array([[True, True, False], [True, True, True]])
    return out, dict(z=z, bonds=bonds, atom_mask=atom_mask, cg_mask=cg_mask,
                     bond_mask=bond_mask)


@pytest.mark.parametrize("kw", [dict(), dict(h_bond_weight=3.0), dict(eta_h=0.5),
                                dict(legacy_kl=True), dict(gamma=0.0)])
def test_losses_match_jax(kw):
    out, g = _random_outputs()
    kw = dict(dict(beta=0.05, gamma=25.0), **kw)
    flat = dict(z=g["z"].reshape(-1), atom_mask=g["atom_mask"].reshape(-1),
                cg_mask=g["cg_mask"].reshape(-1), bond_mask=g["bond_mask"].reshape(-1),
                bonds=(g["bonds"] + 5 * np.arange(2)[:, None, None]).reshape(-1, 2))

    class _G:                                       # the fields vae_loss reads
        pass

    jg = _G()
    for k, v in flat.items():
        setattr(jg, k, jnp.asarray(v))
    jtotal, jm = jlosses.vae_loss(JaxOutput(**{k: jnp.asarray(v) for k, v in out.items()}),
                                  jg, **kw)
    from coarsegrainingvae_tpu_torch.models.cgvae import FlatGraph

    tg = FlatGraph(xyz=torch.as_tensor(out["xyz"]), **{
        k: torch.as_tensor(v).long() if v.dtype == np.int32 else torch.as_tensor(v)
        for k, v in flat.items()})
    ttotal, tm = losses.vae_loss(VAEOutput(**{k: torch.as_tensor(v) for k, v in out.items()}),
                                 tg, **kw)
    assert set(tm) == set(jm)
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-5)


@pytest.mark.parametrize("step", [0, 3, 12])
def test_steric_step_matches_jax(small_dataset, tiny_model_cfg, step):
    """One train step with zeta > 0 and zeta_warmup 8 at step 0 (weight 0),
    mid-ramp and past the ramp: the loss and every metric ("steric" among
    them) of both trainers' steps, and every gradient against jax.grad at
    the ramp's weight, read from the device step."""
    cfg = _exp(_model_cfg(tiny_model_cfg, "default"), gamma=25.0, zeta=50.0,
               zeta_warmup=8)
    z, bonds = np.asarray(small_dataset.z), jlosses_topology_bonds()
    tables = jlosses.build_steric_tables(z, bonds)
    jtr = JaxTrainer(JaxModel(cfg=cfg.model), cfg, mesh=make_mesh(1), steric_tables=tables)
    jstate = jtr.init_state(small_dataset.batch(np.arange(BATCH)), seed=0)
    jstate = jstate.replace(step=jnp.asarray(step, jnp.int32))
    tc = _torch_cfg(cfg)
    model = DenseCGVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    tr = Trainer(model, tc, device="cpu", steric_tables=losses.build_steric_tables(z, bonds))
    idx = np.arange(BATCH)
    jb, tb = small_dataset.batch(idx), _port_dataset(small_dataset).batch(idx)
    rng = jax.random.PRNGKey(0)
    scale = min(step / 8, 1.0)
    jgrads = jax.jit(jax.grad(lambda p, b: jtr._loss_fn(p, b, rng, scale)[0]))(
        jstate.params, jb)
    want = convert_flax_params(jax.device_get(jgrads), tc.model)
    state = tr.init_state(tb)
    with torch.no_grad():
        state.step.fill_(step)
    _, _, got = tr.loss_and_grads(state, tb)
    for name, g in zip(state.params, got):
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 1e-4 * np.abs(ref).max(), err_msg=name)
    _, jm = jtr.train_step(jstate, jb, rng)
    state, tm = tr.train_step(state, tb)
    assert set(tm) == set(jm) and "steric" in tm and float(tm["steric"]) > 0.0
    for k in jm:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=TOL["rtol"],
                                   atol=TOL["atol"], err_msg=k)
    base = float(tm["recon"]) + 0.05 * float(tm["kl"]) + 25.0 * float(tm["graph"])
    np.testing.assert_allclose(float(tm["loss"]) - base, 50.0 * scale * float(tm["steric"]),
                               rtol=1e-3, atol=1e-5)


def jlosses_topology_bonds():
    """The covalent bonds of the small_dataset molecule."""
    from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide

    return synthetic_peptide("dipeptide", n_frames=1, seed=7)[2]


def test_trainer_and_synthetic_data_default_to_the_card(tiny_model_cfg):
    """Trainer and synthetic_peptide run on the card unless the caller
    passes device="cpu"; with no card their defaults raise instead of
    quietly running on the CPU."""
    import inspect

    from coarsegrainingvae_tpu_torch.data import synthetic

    for fn in (Trainer, synthetic.synthetic_peptide, synthetic.relax_frames):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    tc = _torch_cfg(_exp(_model_cfg(tiny_model_cfg, "default")))
    model = DenseCGVAE(tc.model, generator=torch.Generator().manual_seed(0))
    if torch.cuda.is_available():
        assert Trainer(model, tc).device.type == "cuda"
        return
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        Trainer(model, tc)
    assert next(model.parameters()).device.type == "cpu"
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        synthetic.synthetic_peptide("dipeptide", n_frames=2, seed=0)


def test_flatten_batch_matches_jax(small_dataset):
    idx = np.array([3, 1, 4, 1])
    jb = jax_flatten(small_dataset.batch(idx))
    tb = flatten_batch(_port_dataset(small_dataset).batch(idx))
    for k in ("z", "xyz", "atom_mask", "cg_mask", "bonds", "bond_mask"):
        np.testing.assert_array_equal(getattr(tb, k).numpy(), np.asarray(getattr(jb, k)), err_msg=k)


# --------------------------------------------------------------- optimiser
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_optimizer_matches_optax(moment_dtype):
    """Clip at 0.01 then Adam, on identical gradients (some clipped, some
    not); bf16 moments against the JAX package's scale_by_adam_compact."""
    rng = np.random.default_rng(0)
    shapes = [(4, 3), (7,), (2, 2, 5)]
    params = [rng.normal(size=s).astype(np.float32) for s in shapes]
    jtx = jax_make_optimizer(0.01, moment_dtype)
    jstate = jtx.init([jnp.asarray(p) for p in params])
    ttx = make_optimizer(0.01, moment_dtype)
    tstate = ttx.init([torch.as_tensor(p) for p in params])
    for step in range(6):
        scale = 1e-4 if step % 2 else 1.0             # below and above the clip
        grads = [(rng.normal(size=s) * scale).astype(np.float32) for s in shapes]
        jup, jstate = jtx.update([jnp.asarray(g) for g in grads], jstate)
        tup, tstate = ttx.update(flatten([torch.as_tensor(g) for g in grads]), tstate)
        np.testing.assert_allclose(tup.numpy(), _flat_np(jup), rtol=1e-5, atol=1e-7)
    adam = jstate[1]
    assert int(tstate.count) == int(adam.count) == 6
    for a, b in ((tstate.mu, adam.mu), (tstate.nu, adam.nu)):
        assert a.dtype == getattr(torch, moment_dtype)
        np.testing.assert_allclose(a.float().numpy(), _flat_np(b), rtol=1e-5, atol=1e-10)


def _flat_np(leaves):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1) for x in leaves])


# ------------------------------------------------------------ whole model
@pytest.mark.parametrize("impl", ["default", "pallas"])
def test_one_step_gradients_match_jax(small_dataset, tiny_model_cfg, impl):
    """Every parameter's gradient of the total loss: the JAX grad tree goes
    through convert_flax_params, which is linear and so maps gradients as it
    maps weights."""
    cfg = _exp(_model_cfg(tiny_model_cfg, impl), gamma=25.0)
    jtr, jstate, tr = _models(cfg, small_dataset)
    idx = np.arange(BATCH)
    jgrads = jax.jit(jax.grad(lambda p, b: jtr._loss_fn(p, b, jax.random.PRNGKey(0))[0]))(
        jstate.params, small_dataset.batch(idx))
    want = convert_flax_params(jax.device_get(jgrads), tr.cfg.model)
    state = tr.init_state(_port_dataset(small_dataset).batch(idx))
    loss, _ = tr._loss_fn(_port_dataset(small_dataset).batch(idx))
    names = list(state.params)
    got = torch.autograd.grad(loss, [state.params[k] for k in names])
    assert set(names) == set(want)
    for name, g in zip(names, got):
        ref = want[name].numpy()
        # the elementwise tolerance, scaled to the largest gradient of the
        # tensor: entries far below it are sums that cancel
        np.testing.assert_allclose(g.numpy(), ref, rtol=TOL["rtol"],
                                   atol=TOL["atol"] + 1e-4 * np.abs(ref).max(), err_msg=name)


def test_trajectory_matches_jax_trainer(small_dataset, tiny_model_cfg):
    """20 steps of both trainers on the same batch sequence, at f32 with f32
    Adam moments. Losses agree to 2e-4 relative and the parameters to 1e-4
    of each tensor's largest entry plus 2e-5: Adam divides each gradient by
    its own running RMS, so an entry whose gradient is near zero on both
    sides can take steps of up to lr = 1e-3 from rounding alone; such steps
    stay far below the parameters' O(0.1-1) scale."""
    cfg = _exp(_model_cfg(tiny_model_cfg, "default"), gamma=25.0)
    jtr, jstate, tr = _models(cfg, small_dataset)
    tds = _port_dataset(small_dataset)
    state = tr.init_state(tds.batch(np.arange(BATCH)))
    order = np.random.default_rng(1).permutation(len(small_dataset))
    jl, tl = [], []
    for i in range(20):
        idx = np.resize(np.roll(order, -BATCH * i), BATCH)
        jstate, jm = jtr.train_step(jstate, small_dataset.batch(idx), jax.random.PRNGKey(i))
        state, tm = tr.train_step(state, tds.batch(idx))
        jl.append(float(jm["loss"]))
        tl.append(float(tm["loss"]))
        assert float(tm["grad_ok"]) == 1.0
    np.testing.assert_allclose(tl, jl, rtol=2e-4)
    assert tl[-1] < tl[0]
    want = convert_flax_params(jax.device_get(jstate.params), tr.cfg.model)
    for name, p in state.params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=2e-5 + 1e-4 * np.abs(ref).max(), err_msg=name)
    assert int(state.step) == 20 and int(state.opt_state.count) == 20


def test_skip_guard_leaves_params_and_moments(small_dataset, tiny_model_cfg):
    """A loss above gamma * loss_skip_factor is rejected on the device: the
    parameters, both moments and their count stay exactly as they were;
    the step counter still advances."""
    cfg = _exp(_model_cfg(tiny_model_cfg, "default"), gamma=1e-6, loss_skip_factor=1.0)
    tc = _torch_cfg(cfg)
    tr = Trainer(DenseCGVAE(tc.model, generator=torch.Generator().manual_seed(0)), tc,
                 device="cpu")
    tds = _port_dataset(small_dataset)
    state = tr.init_state(tds.batch(np.arange(BATCH)))
    before = {k: p.detach().clone() for k, p in state.params.items()}
    mu, nu = state.opt_state.mu.clone(), state.opt_state.nu.clone()
    state, m = tr.train_step(state, tds.batch(np.arange(BATCH)))
    assert float(m["skipped"]) == 1.0 and float(m["loss"]) > 1e-6
    for k, p in state.params.items():
        torch.testing.assert_close(p.detach(), before[k], rtol=0, atol=0)
    torch.testing.assert_close(state.opt_state.mu, mu, rtol=0, atol=0)
    torch.testing.assert_close(state.opt_state.nu, nu, rtol=0, atol=0)
    assert int(state.opt_state.count) == 0 and int(state.step) == 1


@pytest.mark.parametrize("device_resident", [True, False])
def test_fit_runs_two_epochs(small_dataset, tiny_model_cfg, device_resident, tmp_path):
    """Two epochs on the device-resident path and, for a dataset with aux
    edges (which a DeviceDataset does not hold), on host batches; with a
    checkpoint manager, fit saves the final epoch."""
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    cfg = _exp(dataclasses.replace(tiny_model_cfg, n_basis=16), lr=3e-3)
    tc = _torch_cfg(cfg)
    tr = Trainer(DenseCGVAE(tc.model, generator=torch.Generator().manual_seed(0)), tc,
                 device="cpu")
    if device_resident:
        tds = _port_dataset(small_dataset)
    else:
        z, frames, bonds = synthetic_peptide("dipeptide", n_frames=32, seed=7, device="cpu")
        tds = build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                            bonds, order=2, seed=5, aux_cutoff=2.0)
        assert tds.aux_bonds is not None
    state = tr.init_state(tds.batch(np.arange(BATCH)))
    rows = []
    state, hist = tr.fit(state, tds.subset(np.arange(24)), tds.subset(np.arange(24, 32)),
                         log_fn=rows.append, nepochs=2)
    assert [r["epoch"] for r in hist] == [0, 1] and rows == hist
    for r in hist:
        assert all(np.isfinite(v) for v in r.values())
    assert int(state.step) == 2 * (24 // BATCH)
    from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager

    mgr = CheckpointManager(str(tmp_path))
    state, hist = tr.fit(state, tds.subset(np.arange(24)), tds.subset(np.arange(24, 32)),
                         nepochs=1, ckpt=mgr)
    _, meta, step = mgr.read()
    assert step == 0 and meta["epoch"] == 0 and meta["history"] == json.loads(json.dumps(hist))
