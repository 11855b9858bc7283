"""Tensor parallelism in the PyTorch port (``parallel.tensor``,
``Trainer`` on a ('data', 'model') mesh) against the JAX package's
``tensor_shardings`` and its ``Trainer`` on ``make_mesh(n, model_devices=m)``,
and against the port's own single process.

The port's ranks run on gloo in spawned processes, one world per size
(2 ranks: mesh (1, 2); 4 ranks: mesh (2, 2)) running every case at once
(``tests/torch_parallel_ranks.py``). The JAX side runs on the virtual CPU
devices of ``tests/conftest.py``. The setup is the JAX package's own TP
gate (``tests/test_device_data.py::test_tensor_parallel_2d_mesh_matches_single``:
n_basis 128, so the n_basis-wide leaves qualify for the split, f32 Adam
moments, 3 steps at batch 8) at f32 compute, as the data-parallel gate has
it (``tests/test_torch_parallel.py``).
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, ParallelConfig, TrainConfig
from coarsegrainingvae_tpu.models.cgvae import CGequiVAE as JaxSparse
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh as jax_make_mesh
from coarsegrainingvae_tpu.parallel.mesh import tensor_shardings as jax_tensor_shardings
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params, tensor_layouts
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model
from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks
from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh
from coarsegrainingvae_tpu_torch.parallel.tensor import FeatureSplit, tensor_shardings
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BATCH, STEPS, WIDTH = 8, 3, 128
MESHES = {2: (1, 2), 4: (2, 2)}          # world -> (data, model)
TOL = dict(rtol=1e-4, atol=1e-5)          # the port against JAX, f32
TP_TOL = dict(rtol=2e-5, atol=2e-6)       # JAX's own TP gate: TP against one device
# the default bf16 matmuls with sampling noise: each rank rounds its own
# feature slice and half batch in bf16, so the steps' losses, sums of bf16
# terms, agree to one bf16 rounding (2^-7 of the value). Adam moves an
# element by about lr per step whatever its gradient's size, so an element
# whose gradient is near 0 may move the other way: the parameters agree to
# 2 lr per step
NOISY_LOSS_RTOL = 2.0 ** -7
NOISY_PARAM_TOL = dict(rtol=0, atol=2 * 1e-3 * STEPS)


def _model_cfg(tiny_model_cfg, **kw):
    return dataclasses.replace(tiny_model_cfg, n_basis=WIDTH, enc_nconv=1, dec_nconv=2, **kw)


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


def _sharded_leaves(tree):
    """The flax tree with each leaf 1.0 where the leaf is split over the
    model axis, else 0.0, in the leaf's shape."""
    return jax.tree.map(lambda l: np.full(l.shape, float(not l.sharding.is_fully_replicated),
                                          np.float32), tree)


def _port_names(flags, model_cfg):
    """The port tensors a flag tree maps to that are flagged whole."""
    return {k for k, t in convert_flax_params(flags, model_cfg).items() if bool(t.all())}


@pytest.fixture(scope="module")
def setup(small_dataset, tiny_model_cfg):
    jcfg = _exp(_model_cfg(tiny_model_cfg, det=True, compute_dtype="float32"))
    tds = _port_dataset(small_dataset)
    order = np.random.default_rng(1).permutation(len(small_dataset))
    idx = [order[BATCH * i:BATCH * (i + 1)] for i in range(STEPS)]
    jtr = JaxTrainer(JaxModel(cfg=jcfg.model), jcfg, mesh=jax_make_mesh(1))
    init = jax.device_get(jtr.init_state(small_dataset.batch(idx[0]), seed=0).params)
    port_model = _port(jcfg).model
    sd = {k: t.numpy() for k, t in convert_flax_params(init, port_model).items()}

    def jax_run(data, model):
        c = dataclasses.replace(jcfg, parallel=ParallelConfig(model_devices=model))
        tr = JaxTrainer(JaxModel(cfg=c.model), c, mesh=jax_make_mesh(data * model,
                                                                   model_devices=model))
        state = tr.init_state(small_dataset.batch(idx[0]), seed=0)
        sharded = (_port_names(_sharded_leaves(state.params), port_model),
                   _port_names(_sharded_leaves(state.opt_state[1].mu), port_model),
                   _port_names(_sharded_leaves(state.opt_state[1].nu), port_model))
        losses = []
        for i in range(STEPS):
            state, m = tr.train_step(state, small_dataset.batch(idx[i]), jax.random.PRNGKey(i))
            losses.append(float(jax.device_get(m["loss"])))
        params = {k: t.numpy() for k, t in convert_flax_params(
            jax.device_get(state.params), port_model).items()}
        return params, losses, sharded

    noisy = _port(_exp(_model_cfg(tiny_model_cfg)))
    noisy32 = _port(_exp(_model_cfg(tiny_model_cfg, compute_dtype="float32")))
    sparse = _port(_exp(_model_cfg(tiny_model_cfg, compute_dtype="float32",
                                   dec_type="pseudo2", sparse=True)))
    return dict(jcfg=jcfg, port=_port(jcfg), sd=sd, tds=tds, idx=idx, noisy=noisy, noisy32=noisy32,
                sparse=sparse, batches=[tds.batch(i) for i in idx], jax_run=jax_run)


def _tp(cfg, m, **kw):
    return ranks.replace_parallel(cfg, model_devices=m, **kw)


def _cases(s, world, root):
    m = MESHES[world][1]
    half = dict(train_ds=s["tds"].subset(np.arange(24)), val_ds=s["tds"].subset(np.arange(24, 32)))
    cases = {
        "det": (ranks.train_steps, dict(cfg=_tp(s["port"], m), batches=s["batches"],
                                        state_dict=s["sd"])),
        "zero": (ranks.train_steps, dict(cfg=_tp(s["port"], m, zero_optimizer=True),
                                         batches=s["batches"], state_dict=s["sd"])),
        "noise": (ranks.train_steps, dict(cfg=_tp(s["noisy"], m), batches=s["batches"],
                                          gen_seed=5)),
        "epoch": (ranks.epoch, dict(cfg=_tp(s["noisy32"], m), **half)),
        "recon": (ranks.reconstruct_generate, dict(cfg=_tp(s["noisy32"], m),
                                                   batch=s["batches"][0], state_dict=s["sd"])),
        "ckpt": (ranks.fit_resume, dict(cfg=_tp(s["port"], m), ckpt_dir=str(root / "ckpt"),
                                        continued=True, **half)),
    }
    if world == 2:
        cases["sparse"] = (ranks.train_steps, dict(cfg=_tp(s["sparse"], m), batches=s["batches"],
                                                   gen_seed=7))
    return cases


@pytest.fixture(scope="module")
def worlds(setup, tmp_path_factory):
    """Every case on each mesh, one spawn per world: {world: [per-rank
    results]}; and the one-process runs of the same cases: {1: result}."""
    out = {"roots": {}}
    for world in MESHES:
        root = out["roots"][world] = tmp_path_factory.mktemp(f"tp_world{world}")
        out[world] = spawn_ranks(ranks.run_all, world, str(root / "store"),
                                 (_cases(setup, world, root),))
    root = tmp_path_factory.mktemp("tp_world1")
    one = {name: (fn, dict(kw, cfg=ranks.replace_parallel(kw["cfg"], model_devices=1,
                                                          zero_optimizer=False)))
           for name, (fn, kw) in _cases(setup, 2, root).items() if name not in ("zero", "ckpt")}
    out[1] = {name: fn(**kw, parallel=False) for name, (fn, kw) in one.items()}
    return out


def _close(got, want, tol):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **tol)


def _same_on_every_rank(results, name):
    first = results[0][name]["params"]
    for r in results[1:]:
        for k in first:
            np.testing.assert_array_equal(r[name]["params"][k], first[k], err_msg=k)


def test_partition_agrees_with_jax(setup, tiny_model_cfg):
    """The port tensors sharded at m = 2 are the converted JAX leaves that
    tensor_shardings splits on make_mesh(8, model_devices=2), for the
    dense and the sparse model at n_basis 128 (both pseudo trees of the
    dense one), and some are."""
    from coarsegrainingvae_tpu.data.dataset import CGDatasetArrays as JaxDS

    mesh = jax_make_mesh(8, model_devices=2)
    jbatch = JaxDS(**{f.name: getattr(setup["tds"], f.name)
                      for f in dataclasses.fields(JaxDS)}).batch(np.arange(2))
    for kw in (dict(), dict(pseudo_impl="pallas"), dict(dec_type="cross"),
               dict(dec_type="pseudo2", sparse=True)):
        jm = _model_cfg(tiny_model_cfg, **kw)
        model = (JaxSparse if jm.sparse else JaxModel)(cfg=jm)
        params = jax.eval_shape(model.init, {"params": jax.random.PRNGKey(0),
                                             "sample": jax.random.PRNGKey(1)}, jbatch)["params"]
        specs = jax_tensor_shardings(params, mesh)
        flags = jax.tree.map(lambda l, sp: np.full(l.shape, float(sp.spec != jax.sharding.PartitionSpec()),
                                                   np.float32), params, specs)
        pm = _port(_exp(jm)).model
        want = _port_names(flags, pm)
        shapes = {k: p.shape for k, p in build_flagship_model(pm).named_parameters()}
        got = {k for k, v in tensor_shardings(tensor_layouts(shapes, pm), 2).items() if v}
        assert got == want and got, kw


@pytest.mark.parametrize("world", MESHES)
def test_tensor_parallel_steps_match_jax_tp(setup, worlds, world):
    """3 f32 steps on mesh (data, model) equal JAX's Trainer on
    make_mesh(data * model, model_devices=model): each step's loss and the
    gathered parameters, on every rank alike; the moments the JAX trainer
    shards are the ones each port rank holds 1/m of."""
    data, m = MESHES[world]
    want, losses, (p_set, mu_set, nu_set) = setup["jax_run"](data, m)
    assert p_set == mu_set == nu_set and p_set
    _same_on_every_rank(worlds[world], "det")
    for r in worlds[world]:
        got = r["det"]
        assert got["mesh"] == (data, m)
        _close(got["params"], want, TOL)
        np.testing.assert_allclose([x["loss"] for x in got["metrics"]], losses, **TOL)
        assert set(got["shards"]) == p_set
        n_local = sum(v.size // m if k in p_set else v.size for k, v in setup["sd"].items())
        assert got["moments"] == n_local
        for k, shard in got["shards"].items():
            assert shard.size * m == setup["sd"][k].size


@pytest.mark.parametrize("world", MESHES)
def test_tensor_parallel_equals_one_process(worlds, world):
    """At f32 the TP steps equal the one-process port within JAX's own TP
    tolerance; with the default bf16 matmuls and sampling noise (each
    model group draws the global batch's noise as one process does) the
    losses within NOISY_LOSS_RTOL and the parameters within NOISY_PARAM_TOL."""
    _close(worlds[world][0]["det"]["params"], worlds[1]["det"]["params"], TP_TOL)
    _same_on_every_rank(worlds[world], "noise")
    got, want = worlds[world][0]["noise"], worlds[1]["noise"]
    _close(got["params"], want["params"], NOISY_PARAM_TOL)
    for g, w in zip(got["metrics"], want["metrics"]):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=NOISY_LOSS_RTOL)


@pytest.mark.parametrize("world", MESHES)
def test_tensor_parallel_epoch_and_eval_equal_one_process(worlds, world):
    """An epoch of the static step and an eval epoch under TP against one
    process, f32 with sampling noise: the parameters and every metric's
    epoch mean."""
    got, want = worlds[world][0]["epoch"], worlds[1]["epoch"]
    _close(got["params"], want["params"], TP_TOL)
    for part in ("train", "val"):
        assert got[part]["n_steps"] == want[part]["n_steps"]
        for k, v in want[part].items():
            np.testing.assert_allclose(got[part][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("world", MESHES)
def test_reconstruct_generate_and_eval_under_tensor_parallelism(worlds, world):
    """reconstruct, generate and eval_step on the TP mesh (the message
    blocks split, every rank of a model group on the same rows and draws)
    against one process, f32 with sampling noise, on every rank."""
    want = worlds[1]["recon"]
    for r in worlds[world]:
        got = r["recon"]
        for k in ("recon", "generate"):
            np.testing.assert_allclose(got[k], want[k], err_msg=k, **TP_TOL)
        for k, v in want["eval"].items():
            np.testing.assert_allclose(got["eval"][k], v, rtol=1e-5, atol=1e-7, err_msg=k)


def test_sparse_model_under_tensor_parallelism(worlds):
    """The sparse CGequiVAE on mesh (1, 2) (every leaf gathered, no
    compute split) equals one process at f32."""
    _same_on_every_rank(worlds[2], "sparse")
    _close(worlds[2][0]["sparse"]["params"], worlds[1]["sparse"]["params"], TP_TOL)
    assert worlds[2][0]["sparse"]["shards"]


@pytest.mark.parametrize("world", MESHES)
def test_zero_optimizer_under_tensor_parallelism_runs_tp(worlds, world):
    """ParallelConfig(zero_optimizer=True) with model_devices > 1 runs
    tensor parallelism and no ZeRO, as the JAX package does: the same
    parameters bit for bit and the same moments per rank."""
    for r in worlds[world]:
        assert r["zero"]["moments"] == r["det"]["moments"]
        for k, v in r["det"]["params"].items():
            np.testing.assert_array_equal(r["zero"]["params"][k], v, err_msg=k)


@pytest.mark.parametrize("world", MESHES)
def test_tensor_parallel_checkpoint_resumes_and_loads_in_one_process(setup, worlds, world):
    """fit under TP saves the one-process form (rank 0 writes the gathered
    moments); a TP run resumed from it on a trainer from other weights
    equals the first trainer resumed from it bit for bit (fit restarts
    the shuffle order on every call, as the JAX package does, so a resumed
    run is compared with a resumed run); and the checkpoint loads into a one-process Trainer with the
    parameters the TP run held after its first epoch and every moment."""
    res = worlds[world]
    n_params = sum(v.size for v in setup["sd"].values())
    for r in res:
        c = r["ckpt"]
        assert c["stored_mu"].size == c["stored_nu"].size == n_params
        for k, v in c["continued"].items():
            np.testing.assert_array_equal(c["params"][k], v, err_msg=k)
        for k, v in c["after_one"].items():
            np.testing.assert_array_equal(c["stored_params"][k], v, err_msg=k)
    cfg = setup["port"]
    model = build_flagship_model(cfg.model, generator=torch.Generator().manual_seed(3))
    tr = Trainer(model, cfg, device="cpu", mesh=Mesh(0, 1, None, None, torch.device("cpu")))
    state = tr.init_state(setup["batches"][0])
    state, _, _ = CheckpointManager(str(worlds["roots"][world] / "ckpt")).restore(state, step=0)
    c = res[0]["ckpt"]
    for k, p in state.params.items():
        np.testing.assert_array_equal(p.detach().numpy(), c["after_one"][k], err_msg=k)
    np.testing.assert_array_equal(state.opt_state.mu.numpy(), c["stored_mu"])
    np.testing.assert_array_equal(state.opt_state.nu.numpy(), c["stored_nu"])


def _split(m, f, r):
    return FeatureSplit(Mesh(r, m, None, None, torch.device("cpu")), f)


@pytest.mark.parametrize("block", ["message", "pseudo"])
def test_sliced_message_blocks_equal_the_whole_block(setup, block):
    """One process, no world: a message block's ``local`` on each of the 2
    feature slices at n_basis 128 (the kernels' plain versions at F 64),
    concatenated, gives the block's forward bit for bit; the per-feature
    gradients (the node features the kernel reads, phi_out's columns,
    filter_w) bit for bit; the input s and phi_in, whose gradient is the
    sum of the column-split phi_out's slices, within f32 rounding."""
    model = build_flagship_model(setup["port"].model, generator=torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    b, f, m = 4, WIDTH, 2
    if block == "message":
        mod, n = model.enc_msgs[0], 27
        ins = [torch.randn(b, n, f, generator=g), torch.randn(b, n, 3, f, generator=g)]
    else:
        mod, n = model.dec_msgs[0], 3
        ins = [torch.randn(b, n, f, generator=g), torch.randn(b, n, f, generator=g),
               torch.randn(b, n, 3, f, generator=g), torch.randn(b, n, 3, f, generator=g)]
    xyz = torch.randn(b, n, 3, generator=g) * 3.0
    mask = torch.ones(b, n)
    mask[:, -1] = 0.0

    def run(sliced):
        x = [t.clone().requires_grad_(True) for t in ins]
        if sliced:
            parts = [mod.local(*x, xyz, mask, _split(m, f, r)) for r in range(m)]
            outs = [torch.cat(p, -1) for p in zip(*parts)]
        else:
            outs = mod(*x, xyz, mask)
        loss = sum((o * torch.linspace(-1, 1, o.numel()).view(o.shape)).sum() for o in outs)
        names = [k for k, _ in mod.named_parameters()]
        grads = torch.autograd.grad(loss, x + [p for _, p in mod.named_parameters()])
        return outs, dict(zip(["s"] + [f"in{i}" for i in range(1, len(x))] + names, grads))

    (whole, gw), (sliced, gs) = run(False), run(True)
    for a, c in zip(whole, sliced):
        assert torch.equal(a, c)
    for k in gw:
        if k == "s" or k.startswith("phi_in"):
            torch.testing.assert_close(gs[k], gw[k], rtol=0,
                                       atol=1e-6 * float(gw[k].abs().max()))
        else:
            assert torch.equal(gs[k], gw[k]), k


def test_feature_split_reaches_every_kernel_block(setup):
    """split_messages puts a split on every block that runs a kernel and
    names each one's phi_out and filter_w as partial; a width that does
    not divide by the model axis runs whole."""
    from coarsegrainingvae_tpu_torch.parallel.tensor import split_messages

    model = build_flagship_model(setup["port"].model)
    axis = Mesh(1, 2, None, None, torch.device("cpu"))
    partial = split_messages(model, axis)
    blocks = [n for n, mod in model.named_modules() if hasattr(mod, "feature_split")]
    assert len(blocks) == 2 * setup["port"].model.enc_nconv + setup["port"].model.dec_nconv
    assert len(partial) == 3 * len(blocks)
    assert all(model.get_submodule(n).feature_split.lo == WIDTH // 2 for n in blocks)
    split_messages(model, Mesh(1, 3, None, None, torch.device("cpu")))
    assert all(model.get_submodule(n).feature_split is None for n in blocks)
