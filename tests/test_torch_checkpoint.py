"""Checkpoints of the PyTorch port: the round trip of a full train state,
retention, atomic saves, and ``Trainer.fit`` resuming from its latest
checkpoint (the JAX package's ``test_fit_resume_continues_from_epoch``,
ported) with per-epoch noise that does not depend on where a run started.

The port's checkpoints are ``torch.save`` files, so every comparison here is
bit for bit (rtol 0, atol 0)."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.models import dense_cgvae
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.train import checkpoint as ckpt_mod
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BATCH = 8
EXACT = dict(rtol=0, atol=0)


@pytest.fixture(scope="module")
def port_ds(small_dataset):
    return CGDatasetArrays(**{f.name: getattr(small_dataset, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


def _cfg(tiny_model_cfg, **train_kw):
    model = tcfg.ModelConfig(**dataclasses.asdict(dataclasses.replace(tiny_model_cfg, n_basis=16)))
    train = dict(lr=3e-3, beta=0.05, gamma=1.0, adam_moment_dtype="bfloat16",
                 checkpoint_every=1)
    train.update(train_kw)
    return tcfg.ExperimentConfig(model=model, data=tcfg.DataConfig(batch_size=BATCH, seed=0),
                                 train=tcfg.TrainConfig(**train))


def _trainer(cfg, seed):
    return Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(seed)), cfg,
                   device="cpu")


def _trained_state(cfg, ds, seed=0):
    """A trainer and its state after two steps, so every moment is set."""
    tr = _trainer(cfg, seed)
    state = tr.init_state(ds.batch(np.arange(BATCH)))
    for lo in (0, BATCH):
        state, _ = tr.train_step(state, ds.batch(np.arange(lo, lo + BATCH)))
    return tr, state


def _assert_state_equal(got, want):
    assert list(got.params) == list(want.params)
    for name, p in want.params.items():
        torch.testing.assert_close(got.params[name].detach(), p.detach(), **EXACT)
    for field in ("count", "mu", "nu"):
        a, b = getattr(got.opt_state, field), getattr(want.opt_state, field)
        assert a.dtype == b.dtype
        torch.testing.assert_close(a, b, **EXACT)
    torch.testing.assert_close(got.step, want.step, **EXACT)
    torch.testing.assert_close(got.lr, want.lr, **EXACT)


def test_round_trip_is_bit_identical(port_ds, tiny_model_cfg, tmp_path):
    cfg = _cfg(tiny_model_cfg)
    _, state = _trained_state(cfg, port_ds)
    assert state.opt_state.mu.dtype == torch.bfloat16 and int(state.opt_state.count) == 2
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    meta = {"epoch": 3, "controller": {"lr": 1e-3, "history": [1.5, float("nan")]},
            "note": "x"}
    mgr.save(3, state, metadata=meta)

    tr2 = _trainer(cfg, seed=9)                        # another initialisation
    template = tr2.init_state(port_ds.batch(np.arange(BATCH)))
    restored, got_meta, step = mgr.restore(template)
    assert step == 3 and mgr.latest_step() == 3
    assert json.dumps(got_meta) == json.dumps(meta)
    _assert_state_equal(restored, state)
    # restore copies into the model's own parameters: the model trains them
    for name, p in tr2.model.named_parameters():
        assert restored.params[name] is p
    # the stored file is plain tensors that torch.load reads back
    payload = torch.load(tmp_path / "ckpt" / "3" / ckpt_mod.STATE_FILE, weights_only=True)
    assert set(payload) == {"params", "opt_state", "step", "lr"}
    torch.testing.assert_close(payload["opt_state"]["nu"], state.opt_state.nu, **EXACT)


def test_restore_refuses_another_model(port_ds, tiny_model_cfg, tmp_path):
    cfg = _cfg(tiny_model_cfg)
    _, state = _trained_state(cfg, port_ds)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(0, state)
    other = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dec_nconv=1))
    template = _trainer(other, 0).init_state(port_ds.batch(np.arange(BATCH)))
    with pytest.raises(KeyError, match="unexpected"):
        mgr.restore(template)
    wider = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, n_basis=20))
    template = _trainer(wider, 0).init_state(port_ds.batch(np.arange(BATCH)))
    with pytest.raises(ValueError, match="expected"):
        mgr.restore(template)


def test_retention_keeps_the_newest(port_ds, tiny_model_cfg, tmp_path):
    cfg = _cfg(tiny_model_cfg)
    tr = _trainer(cfg, 0)
    state = tr.init_state(port_ds.batch(np.arange(BATCH)))
    mgr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(5):
        mgr.save(step, state, metadata={"epoch": step})
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert sorted(os.listdir(tmp_path)) == ["3", "4", "meta_3.json", "meta_4.json"]
    _, meta, step = mgr.read(3)
    assert step == 3 and meta == {"epoch": 3}


def test_restore_without_checkpoint_raises(port_ds, tiny_model_cfg, tmp_path):
    mgr = CheckpointManager(str(tmp_path / "empty"))
    assert mgr.latest_step() is None
    template = _trainer(_cfg(tiny_model_cfg), 0).init_state(port_ds.batch(np.arange(BATCH)))
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        mgr.restore(template)


def test_interrupted_save_is_not_latest(port_ds, tiny_model_cfg, tmp_path, monkeypatch):
    cfg = _cfg(tiny_model_cfg)
    tr = _trainer(cfg, 0)
    state = tr.init_state(port_ds.batch(np.arange(BATCH)))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(1, state, metadata={"epoch": 1})

    def killed(obj, path):
        with open(path, "wb") as f:
            f.write(b"partial")
        raise KeyboardInterrupt("killed while writing")

    monkeypatch.setattr(ckpt_mod.torch, "save", killed)
    with pytest.raises(KeyboardInterrupt):
        mgr.save(2, state, metadata={"epoch": 2})
    monkeypatch.undo()
    assert mgr.latest_step() == 1 and os.path.isdir(tmp_path / ".tmp_2")
    _, meta, step = mgr.read()
    assert step == 1 and meta == {"epoch": 1}
    mgr.save(2, state, metadata={"epoch": 2})            # the next save completes
    assert mgr.latest_step() == 2 and not os.path.exists(tmp_path / ".tmp_2")


def test_fit_resume_continues_from_epoch(port_ds, tiny_model_cfg, tmp_path):
    cfg = _cfg(tiny_model_cfg)
    train, val = port_ds.subset(np.arange(24)), port_ds.subset(np.arange(24, 32))
    tr = _trainer(cfg, 0)
    mgr = CheckpointManager(str(tmp_path / "c2"))
    state = tr.init_state(port_ds.batch(np.arange(BATCH)))
    state, hist = tr.fit(state, train, val, nepochs=2, ckpt=mgr)
    assert len(hist) == 2 and mgr.all_steps() == [0, 1]

    # a fresh trainer resumes at epoch 2 and runs exactly 2 more epochs
    tr2 = _trainer(cfg, 7)
    state2 = tr2.init_state(port_ds.batch(np.arange(BATCH)))
    state2, hist2 = tr2.fit(state2, train, val, nepochs=4, ckpt=mgr, resume=True)
    assert [h["epoch"] for h in hist2] == [0, 1, 2, 3]
    assert len([h for h in hist2 if h["epoch"] >= 2]) == 2
    assert json.dumps(hist2[:2]) == json.dumps(hist)    # the history came back
    assert int(state2.step) == 4 * (24 // BATCH) and mgr.latest_step() == 3
    _, meta, _ = mgr.read()
    assert meta["epoch"] == 3 and len(meta["history"]) == 4
    assert set(meta["controller"]) == {"lr", "history", "best", "num_bad"}
    assert set(meta["stopper"]) == {"counter", "best_loss", "early_stop"}


def test_resumed_epoch_draws_the_noise_of_the_uninterrupted_run(
        port_ds, tiny_model_cfg, tmp_path, monkeypatch):
    """Epoch e's noise comes from generators seeded from (seed, e), so a run
    resumed at epoch 2 draws at epochs 2 and 3 what a run of 4 epochs draws
    there (the shuffle order restarts, as the JAX package's does)."""
    cfg = _cfg(tiny_model_cfg)
    train, val = port_ds.subset(np.arange(24)), port_ds.subset(np.arange(24, 32))
    current = []                    # the draws since the last epoch ended
    original = dense_cgvae.draw_eps

    def recording(like, generator, eps):
        out = original(like, generator, eps)
        current.append(out.clone())
        return out

    monkeypatch.setattr(dense_cgvae, "draw_eps", recording)

    def run(nepochs, mgr, resume, seed):
        """{epoch: the noise it drew} of one fit call."""
        per_epoch = {}
        current.clear()

        def log(row):
            per_epoch[row["epoch"]] = list(current)
            current.clear()

        tr = _trainer(cfg, seed)
        state = tr.init_state(port_ds.batch(np.arange(BATCH)))
        tr.fit(state, train, val, nepochs=nepochs, ckpt=mgr, resume=resume, log_fn=log)
        return per_epoch

    full = run(4, None, False, 0)
    mgr = CheckpointManager(str(tmp_path))
    first = run(2, mgr, False, 0)
    resumed = run(4, mgr, True, 5)
    assert sorted(full) == [0, 1, 2, 3] and sorted(first) == [0, 1]
    assert sorted(resumed) == [2, 3]
    for e in (0, 1):
        for a, b in zip(first[e], full[e]):
            torch.testing.assert_close(a, b, **EXACT)
    for e in (2, 3):
        assert len(resumed[e]) == len(full[e]) == 24 // BATCH + 1   # train steps + val
        for a, b in zip(resumed[e], full[e]):
            torch.testing.assert_close(a, b, **EXACT)
    # and the epochs differ from each other
    assert float((full[2][0] - full[3][0]).abs().max()) > 0.1
