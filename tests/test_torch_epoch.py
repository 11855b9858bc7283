"""The port's epoch as one program (``run_epoch_scan``,
``run_epoch_scan_eval``) against the JAX package's ``lax.scan`` epochs, and
against the port's own eager steps.

Both packages run on the CPU at f32, on the same batches and the same
converted parameters. On the CPU the port's static-buffer step runs in a
Python loop (on a card it is replayed from a CUDA graph:
tests/test_torch_gpu.py)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, TrainConfig
from coarsegrainingvae_tpu.data.device import DeviceDataset as JaxDeviceDataset
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BATCH = 8
# f32, the same arithmetic in another order (tests/test_torch_train.py's
# trajectory test): losses to 2e-4 relative, parameters to 2e-5 plus 1e-4 of
# each tensor's largest entry (Adam turns rounding-level gradients of
# entries near zero into steps of up to lr)
LOSS_RTOL = 2e-4


def _cfg(tiny_model_cfg, det=True) -> ExperimentConfig:
    return ExperimentConfig(
        model=dataclasses.replace(tiny_model_cfg, det=det, compute_dtype="float32"),
        data=DataConfig(batch_size=BATCH, seed=0),
        train=TrainConfig(lr=1e-3, beta=0.05, gamma=25.0, grad_clip=0.01,
                          adam_moment_dtype="float32"))


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


def _models(cfg, jds):
    """The JAX trainer and state; the port's trainer and state on the same
    parameters."""
    jtr = JaxTrainer(JaxModel(cfg=cfg.model), cfg, mesh=make_mesh(1))
    jstate = jtr.init_state(jds.batch(np.arange(BATCH)), seed=0)
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    model = DenseCGVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    tr = Trainer(model, tc, device="cpu")
    return jtr, jstate, tr, tr.init_state(_port_dataset(jds).batch(np.arange(BATCH)))


def _assert_params_match(tr, jstate, state):
    want = convert_flax_params(jax.device_get(jstate.params), tr.cfg.model)
    for name, p in state.params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=2e-5 + 1e-4 * np.abs(ref).max(), err_msg=name)


def test_run_epoch_scan_matches_jax(small_dataset, tiny_model_cfg):
    jtr, jstate, tr, state = _models(_cfg(tiny_model_cfg), small_dataset)
    jstate, jm = jtr.run_epoch_scan(jstate, JaxDeviceDataset.from_dataset(small_dataset),
                                    jax.random.PRNGKey(0), shuffle_rng=np.random.default_rng(5))
    dds = DeviceDataset.from_dataset(_port_dataset(small_dataset), "cpu")
    state, m = tr.run_epoch_scan(state, dds, torch.Generator().manual_seed(0),
                                 shuffle_rng=np.random.default_rng(5))
    assert m["n_steps"] == jm["n_steps"] == len(small_dataset) // BATCH
    assert set(m) == set(jm)
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=LOSS_RTOL)
    _assert_params_match(tr, jstate, state)
    assert int(state.step) == jm["n_steps"] == int(state.opt_state.count)


def test_run_epoch_scan_equals_train_step_loop(small_dataset, tiny_model_cfg):
    """The static-buffer step in a loop against ``train_step`` over the
    same batches gathered on the device, with the model's noise on: every
    metric's epoch mean, parameter, moment and counter bit for bit."""
    tc = tcfg.ExperimentConfig.from_json(_cfg(tiny_model_cfg, det=False).to_json())
    runs = []
    for scan in (True, False):
        tr = Trainer(DenseCGVAE(tc.model, generator=torch.Generator().manual_seed(0)), tc,
                     device="cpu")
        tds = _port_dataset(small_dataset)
        state = tr.init_state(tds.batch(np.arange(BATCH)))
        dds = DeviceDataset.from_dataset(tds, "cpu")
        gen = torch.Generator().manual_seed(3)
        epochs = []
        for _ in range(2):
            rng = np.random.default_rng(len(epochs))
            if scan:
                state, m = tr.run_epoch_scan(state, dds, gen, shuffle_rng=rng)
            else:
                batches = epoch_index_batches(dds.n_frames, BATCH, rng)
                steps = []
                for idx in torch.as_tensor(batches, dtype=torch.long):
                    state, metrics = tr.train_step(state, dds.gather(idx), gen)
                    steps.append(metrics)
                m = {k: float(np.mean(torch.stack([s[k] for s in steps]).float().numpy()))
                     for k in steps[0]}
                m["n_steps"] = len(steps)
            epochs.append(m)
        runs.append((epochs, state, gen.get_state()))
    (m_scan, s_scan, g_scan), (m_dev, s_dev, g_dev) = runs
    assert m_scan == m_dev
    for k in s_scan.params:
        assert torch.equal(s_scan.params[k], s_dev.params[k]), k
    for a, b in ((s_scan.opt_state.mu, s_dev.opt_state.mu), (s_scan.opt_state.nu, s_dev.opt_state.nu),
                 (s_scan.opt_state.count, s_dev.opt_state.count), (s_scan.step, s_dev.step)):
        assert torch.equal(a, b)
    assert torch.equal(g_scan, g_dev)          # the generator advanced alike


def test_run_epoch_scan_eval_matches_jax(small_dataset, tiny_model_cfg):
    jtr, jstate, tr, state = _models(_cfg(tiny_model_cfg), small_dataset)
    val = small_dataset.subset(np.arange(20))       # cycled to 2 whole batches
    jm = jtr.run_epoch_scan_eval(jstate.params, JaxDeviceDataset.from_dataset(val),
                                 jax.random.PRNGKey(1))
    m = tr.run_epoch_scan_eval(state.params, DeviceDataset.from_dataset(_port_dataset(val), "cpu"),
                               torch.Generator().manual_seed(1))
    assert m["n_steps"] == jm["n_steps"] == 2 and set(m) == set(jm)
    for k in jm:
        np.testing.assert_allclose(m[k], jm[k], rtol=LOSS_RTOL, atol=1e-6, err_msg=k)


def test_fit_resume_equals_uninterrupted(small_dataset, tiny_model_cfg, tmp_path):
    """fit for one epoch, then resume to two, against two epochs in one
    call, with the model's noise on (each epoch's generator seeded from
    (seed, epoch), fault C1): parameters bit for bit, the same history. The
    training frames are one frame repeated: the shuffle restarts from
    default_rng(seed) in every fit call, as in the JAX package, and only
    then do both runs see the same batches."""
    cfg = _cfg(tiny_model_cfg, det=False)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, checkpoint_every=1))
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    tds = _port_dataset(small_dataset)
    train, val = tds.subset(np.zeros(24, dtype=int)), tds.subset(np.arange(24, 32))

    def fresh():
        tr = Trainer(DenseCGVAE(tc.model, generator=torch.Generator().manual_seed(0)), tc,
                     device="cpu")
        return tr, tr.init_state(tds.batch(np.arange(BATCH)))

    tr, state = fresh()
    state, hist = tr.fit(state, train, val, nepochs=2)
    tr2, state2 = fresh()
    mgr = CheckpointManager(str(tmp_path))
    tr2.fit(state2, train, val, nepochs=1, ckpt=mgr)
    tr3, state3 = fresh()
    state3, hist3 = tr3.fit(state3, train, val, nepochs=2, ckpt=mgr, resume=True)
    assert [r["epoch"] for r in hist3] == [0, 1]
    for a, b in zip(hist, hist3):
        assert {k: v for k, v in a.items() if k != "epoch_time_s"} == \
            {k: v for k, v in b.items() if k != "epoch_time_s"}
    for k in state.params:
        assert torch.equal(state.params[k], state3.params[k]), k
    assert torch.equal(state.opt_state.mu, state3.opt_state.mu)
    assert int(state3.step) == 2 * (24 // BATCH)
