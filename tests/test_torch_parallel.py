"""Data-parallel training in the PyTorch port (``parallel.mesh``,
``Trainer(mesh=...)``) against the JAX package's ``Trainer`` on
``make_mesh(n)``, and against the port's own single process.

The port's ranks run on gloo in spawned processes (one torch thread each),
the process group formed over a ``FileStore`` under the module's temporary
directory, so xdist workers never share a port. One world per size runs
every case of the module at once (``tests/torch_parallel_ranks.py``) and
returns arrays. The JAX side runs on the virtual CPU devices of
``tests/conftest.py``. All at f32; the JAX comparisons with ``det=True``
(no sampling noise), the port's world-vs-world comparisons with noise.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, ParallelConfig, TrainConfig
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.parallel import mesh as pmesh
from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(1)

BATCH, STEPS, WORLDS = 8, 3, (2, 4)
TOL = dict(rtol=1e-4, atol=1e-5)


def _exp(model_cfg, **parallel) -> ExperimentConfig:
    return ExperimentConfig(
        model=model_cfg, data=DataConfig(batch_size=BATCH, seed=0),
        train=TrainConfig(lr=1e-3, beta=0.05, gamma=1.0, grad_clip=0.01,
                          adam_moment_dtype="float32"),
        parallel=ParallelConfig(**parallel))


def _port(cfg: ExperimentConfig) -> tcfg.ExperimentConfig:
    return tcfg.ExperimentConfig.from_json(cfg.to_json())


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


def _order(n_frames):
    return np.random.default_rng(1).permutation(n_frames)


@pytest.fixture(scope="module")
def setup(small_dataset, tiny_model_cfg):
    """The configurations, batches and converted JAX parameters of every
    case, and the JAX runs."""
    jcfg = _exp(dataclasses.replace(tiny_model_cfg, det=True, compute_dtype="float32"))
    tds = _port_dataset(small_dataset)
    order = _order(len(small_dataset))
    idx = [order[BATCH * i:BATCH * (i + 1)] for i in range(STEPS)]
    jtr = JaxTrainer(JaxModel(cfg=jcfg.model), jcfg, mesh=jax_make_mesh(1))
    init = jax.device_get(jtr.init_state(small_dataset.batch(idx[0]), seed=0).params)
    sd = {k: t.numpy() for k, t in convert_flax_params(init, _port(jcfg).model).items()}

    def jax_run(n):
        tr = JaxTrainer(JaxModel(cfg=jcfg.model), jcfg, mesh=jax_make_mesh(n))
        state = tr.init_state(small_dataset.batch(idx[0]), seed=0)
        for i in range(STEPS):
            state, _ = tr.train_step(state, small_dataset.batch(idx[i]), jax.random.PRNGKey(i))
        return {k: t.numpy() for k, t in convert_flax_params(
            jax.device_get(state.params), _port(jcfg).model).items()}

    noisy = _port(_exp(dataclasses.replace(tiny_model_cfg, compute_dtype="float32")))
    sparse = _port(_exp(dataclasses.replace(tiny_model_cfg, compute_dtype="float32",
                                            dec_type="pseudo2", sparse=True)))
    batches = [tds.batch(i) for i in idx]
    # masked loss terms whose counts differ across ranks: a bond and an atom
    # of the first frame masked out, the rows of the first rank only
    masked = [tds.batch(i) for i in idx]
    for b in masked:
        b.bond_mask[0, :5] = False
        b.atom_mask[0, -1] = False
    return dict(jcfg=jcfg, port=_port(jcfg), sd=sd, tds=tds, idx=idx, batches=batches,
                noisy=noisy, sparse=sparse, masked=masked, jax_run=jax_run)


def _cases(s, world, ckpt_root):
    port = s["port"]
    half = dict(train_ds=s["tds"].subset(np.arange(24)),
                val_ds=s["tds"].subset(np.arange(24, 32)))
    odd = s["tds"].batch(_order(len(s["tds"]))[:2 * world - 1])    # not divisible by world
    bad = s["tds"].batch(s["idx"][0])
    bad.xyz[-1] = float("nan")                                   # the last rank's rows
    return {
        "det": (ranks.train_steps, dict(cfg=port, batches=s["batches"], state_dict=s["sd"])),
        "zero": (ranks.train_steps, dict(cfg=ranks.replace_parallel(port, zero_optimizer=True),
                                         batches=s["batches"], state_dict=s["sd"])),
        "noise": (ranks.train_steps, dict(cfg=s["noisy"], batches=s["batches"], gen_seed=5)),
        "odd": (ranks.train_steps, dict(cfg=s["noisy"], batches=[odd, odd], gen_seed=6)),
        "nonfinite": (ranks.train_steps, dict(cfg=port, batches=[bad], state_dict=s["sd"])),
        "sparse": (ranks.train_steps, dict(cfg=s["sparse"], batches=s["masked"], gen_seed=7)),
        "epoch": (ranks.epoch, dict(cfg=s["noisy"], **half)),
        "ckpt": (ranks.fit_resume, dict(cfg=port, ckpt_dir=str(ckpt_root / "replicated"),
                                        **half)),
        "ckpt_zero": (ranks.fit_resume, dict(
            cfg=ranks.replace_parallel(port, zero_optimizer=True),
            ckpt_dir=str(ckpt_root / "zero"), **half)),
    }


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """Every case on each world size, one spawn per size: {world: [per-rank
    results]}; and on one process with no group: {1: result}."""
    out = {}
    for world in WORLDS:
        root = tmp_path_factory.mktemp(f"world{world}")
        out[world] = spawn_ranks(ranks.run_all, world, str(root / "store"),
                                 (_cases(setup, world, root),))
    root = tmp_path_factory.mktemp("world1")
    out[1] = {name: fn(**kw, parallel=False) for name, (fn, kw) in _cases(setup, 2, root).items()
              if name not in ("odd",)}
    return out


def _close(got, want, tol=TOL):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _same_on_every_rank(results, name):
    first = results[0][name]["params"]
    for r in results[1:]:
        for k in first:
            np.testing.assert_array_equal(r[name]["params"][k], first[k], err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_data_parallel_steps_match_jax_mesh(setup, worlds, world):
    """3 steps on `world` gloo ranks equal JAX's Trainer on make_mesh(world)
    from the same converted parameters and batches (det=True, f32), and
    every rank holds the same parameters."""
    _same_on_every_rank(worlds[world], "det")
    _close(worlds[world][0]["det"]["params"], setup["jax_run"](world))


@pytest.mark.parametrize("world", WORLDS)
def test_zero1_matches_the_replicated_optimizer(setup, worlds, world):
    """ZeRO-1 gives the replicated optimizer's parameters, each rank holding
    the moments of ceil(P / n) entries."""
    res = worlds[world]
    n_params = sum(v.size for v in setup["sd"].values())
    for r in res:
        assert r["zero"]["moments"] == -(-n_params // world)
        assert r["det"]["moments"] == n_params
        for k, v in r["det"]["params"].items():
            np.testing.assert_array_equal(r["zero"]["params"][k], v, err_msg=k)


def test_noise_is_the_global_batch_draw(worlds):
    """With sampling noise, world 2 trains as one process does: each rank
    draws the global batch's noise and keeps its rows."""
    _same_on_every_rank(worlds[2], "noise")
    _close(worlds[2][0]["noise"]["params"], worlds[1]["noise"]["params"])
    for got, want in zip(worlds[2][0]["noise"]["metrics"], worlds[1]["noise"]["metrics"]):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)


def test_sparse_masked_terms_match_one_process(worlds):
    """The sparse CGequiVAE at world 2 against one process, on batches whose
    masked atom and bonds fall in the first rank's rows only: each loss
    term is the global batch's mean."""
    _close(worlds[2][0]["sparse"]["params"], worlds[1]["sparse"]["params"])
    for got, want in zip(worlds[2][1]["sparse"]["metrics"], worlds[1]["sparse"]["metrics"]):
        for k in ("loss", "recon", "kl", "graph"):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("world", WORLDS)
def test_nonfinite_rows_reject_the_step_on_every_rank(worlds, world):
    """A NaN in the last rank's rows rejects the step on every rank: every
    rank leaves its parameters as they were."""
    for r in worlds[world]:
        assert r["nonfinite"]["metrics"][0]["skipped"] == 1.0
        assert r["nonfinite"]["unchanged"]


@pytest.mark.parametrize("world", WORLDS)
def test_indivisible_batch_runs_replicated(setup, worlds, world):
    """A global batch of 2n - 1 rows does not divide by n: every rank
    computes it whole, and the steps equal one process's."""
    odd = setup["tds"].batch(_order(len(setup["tds"]))[:2 * world - 1])
    want = ranks.train_steps(setup["noisy"], [odd, odd], parallel=False, gen_seed=6)
    _same_on_every_rank(worlds[world], "odd")
    _close(worlds[world][0]["odd"]["params"], want["params"])


def test_epoch_at_world_two_matches_one_process(worlds):
    """An epoch of the static step and an eval epoch at world 2 against one
    process: the parameters, and the epoch means of every metric."""
    got, want = worlds[2][0]["epoch"], worlds[1]["epoch"]
    _close(got["params"], want["params"])
    for part in ("train", "val"):
        assert got[part]["n_steps"] == want[part]["n_steps"]
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_shard_rows_and_zero_partition():
    mesh = pmesh.Mesh(1, 4, None, "gloo", torch.device("cpu"))
    assert pmesh.shard_rows(8, mesh) == slice(2, 4)
    assert pmesh.shard_rows(6, mesh) == slice(0, 6)
    part, padded = pmesh.zero_partition(10, mesh)
    assert (part, padded) == (slice(3, 6), 12)


def test_model_devices_above_one_raises():
    """Without a process group one device does not factor into a model
    axis of 2: make_mesh and the Trainer raise JAX's ValueError (the
    worlds that do factor train tensor-parallel, test_torch_tensor_parallel.py)."""
    with pytest.raises(ValueError, match="1 devices do not factor into model_devices=2"):
        pmesh.make_mesh(model_devices=2)
    cfg = tcfg.ExperimentConfig(parallel=tcfg.ParallelConfig(model_devices=2))
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    with pytest.raises(ValueError, match="do not factor into model_devices=2"):
        Trainer(DenseCGVAE(tcfg.ModelConfig(n_basis=8, enc_nconv=1, dec_nconv=1)), cfg,
                device="cpu")
    with pytest.raises(ValueError, match="do not factor"):
        jax_make_mesh(3, model_devices=2)


def test_a_mesh_of_many_ranks_needs_a_process_group():
    assert not torch.distributed.is_initialized()
    assert pmesh.make_mesh(device="cpu").group is None
    with pytest.raises(ValueError, match="process group"):
        pmesh.make_mesh(2)


def test_parallel_config_round_trips(tiny_model_cfg):
    """ParallelConfig through ExperimentConfig.to_json / from_json, in the
    port and from the JAX package's JSON."""
    cfg = tcfg.ExperimentConfig(parallel=tcfg.ParallelConfig(
        data_axis="d", num_devices=4, model_devices=1, zero_optimizer=True))
    assert tcfg.ExperimentConfig.from_json(cfg.to_json()) == cfg
    jcfg = _exp(tiny_model_cfg, num_devices=2, zero_optimizer=True)
    back = tcfg.ExperimentConfig.from_json(jcfg.to_json())
    assert dataclasses.asdict(back.parallel) == dataclasses.asdict(jcfg.parallel)
    assert json.loads(back.to_json())["parallel"] == json.loads(jcfg.to_json())["parallel"]


@pytest.mark.parametrize("world", WORLDS)
def test_zero1_checkpoints_hold_every_moment_and_resume(setup, worlds, world):
    """fit with ZeRO-1 saves the gathered moments of every rank (rank 0
    writes), equal to the replicated optimizer's; a run resumed from it,
    each rank taking back its slice, equals the replicated run resumed."""
    n_params = sum(v.size for v in setup["sd"].values())
    for r in worlds[world]:
        rep, zero = r["ckpt"], r["ckpt_zero"]
        assert zero["stored_mu"].size == rep["stored_mu"].size == n_params
        np.testing.assert_array_equal(zero["stored_mu"], rep["stored_mu"])
        np.testing.assert_array_equal(zero["stored_nu"], rep["stored_nu"])
        assert zero["mu"].size == -(-n_params // world)
        for k, v in rep["params"].items():
            np.testing.assert_array_equal(zero["params"][k], v, err_msg=k)
    _close(worlds[world][0]["ckpt"]["params"], worlds[1]["ckpt"]["params"])


def test_spawn_ranks_raises_what_a_rank_raised(tmp_path):
    """A rank that raises fails the whole launch with its own error, while
    the rank it leaves waiting at a barrier is ended too."""
    with pytest.raises(RuntimeError, match="ValueError: rank 1 fails"):
        spawn_ranks(ranks.fail_on, 2, str(tmp_path / "store"), (1,), timeout=120)
