"""The sparse CGequiVAE of the PyTorch port against the JAX package's, on
the same batches and the same converted parameters.

Both packages run on the CPU: the JAX model jitted (the sparse path has no
Pallas kernel, only ``jax.ops.segment_sum``), the port's through its CSR
segment sums. Every decoder type, ``degree_norm``, ``equivariant=False``
and ``h_project``: the forward's six outputs and every parameter's
gradient of the total loss (one step), at f32 with ``det=True``. Then the
default bf16 compute dtype, the prior path with injected noise, and the
port's epoch program against its eager epoch.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from coarsegrainingvae_tpu.models.cgvae import CGequiVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

BATCH = 4
FIELDS = ("mu", "sigma", "prior_mu", "prior_sigma", "xyz", "xyz_recon")
# f32: the same arithmetic, summed in another order (segment sums, flax vs
# torch matmuls)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both sides round every Dense input, weight and output to bf16
# (relative step 2^-8), but XLA and torch accumulate the bf16 matmuls and
# the bf16 segment sums of the mean heads differently, so single elements
# differ by a bf16 step or two at O(1) magnitudes (tests/test_torch_model.py
# states the same bound for the dense model)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)

CASES = {
    "pseudo": dict(dec_type="pseudo"),
    "pseudo2": dict(dec_type="pseudo2"),
    "cross": dict(dec_type="cross"),
    "painn": dict(dec_type="painn"),
    "en": dict(dec_type="en"),
    "inv": dict(dec_type="inv"),
    "cross_degree_norm": dict(dec_type="cross", degree_norm=True),
    "pseudo_not_equivariant": dict(dec_type="pseudo", equivariant=False),
    "pseudo2_h_project": dict(dec_type="pseudo2", h_project=True),
}


def _cfg(dtype="float32", **kw) -> ExperimentConfig:
    model = ModelConfig(n_cgs=3, n_basis=16, n_rbf=5, atom_cutoff=8.5, cg_cutoff=9.5,
                        enc_nconv=2, dec_nconv=2, activation="swish", breaksym=True,
                        det=True, compute_dtype=dtype, sparse=True, **kw)
    return ExperimentConfig(model=model, data=DataConfig(batch_size=BATCH, seed=0),
                            train=TrainConfig(lr=1e-3, beta=0.05, gamma=25.0,
                                              adam_moment_dtype="float32"))


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


def _pair(cfg: ExperimentConfig, jds):
    """The JAX trainer and parameters, and the port's trainer (CPU) on the
    converted parameters."""
    jtr = JaxTrainer(JaxModel(cfg=cfg.model), cfg, mesh=make_mesh(1))
    jstate = jtr.init_state(jds.batch(np.arange(BATCH)), seed=0)
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    model = CGequiVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    return jtr, jstate, Trainer(model, tc, device="cpu")


@pytest.mark.parametrize("case", list(CASES))
def test_forward_and_gradients_match_jax(small_dataset, case):
    cfg = _cfg(**CASES[case])
    jtr, jstate, tr = _pair(cfg, small_dataset)
    idx = np.arange(BATCH)
    jb = small_dataset.batch(idx)
    tb = _port_dataset(small_dataset).batch(idx)
    rng = jax.random.PRNGKey(0)
    ref = jax.jit(lambda p, b: jtr.model.apply({"params": p}, b, rngs={"sample": rng}))(
        jstate.params, jb)
    with torch.no_grad():
        out = tr.model(tb)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   **F32_TOL, err_msg=f)

    jgrads = jax.jit(jax.grad(lambda p, b: jtr._loss_fn(p, b, rng)[0]))(jstate.params, jb)
    want = convert_flax_params(jax.device_get(jgrads), tr.cfg.model)
    state = tr.init_state(tb)
    loss, _ = tr._loss_fn(tb)
    names = list(state.params)
    got = torch.autograd.grad(loss, [state.params[k] for k in names], allow_unused=True)
    assert set(names) == set(want)
    for name, g in zip(names, got):
        # parameters that reach no output (pseudo2's last dvbar mix) get
        # zeros from jax.grad and None from torch
        g = torch.zeros_like(state.params[name]) if g is None else g
        ref_g = want[name].numpy()
        # the elementwise tolerance, and 1e-4 of the tensor's largest
        # gradient for entries that are sums cancelling far below it
        np.testing.assert_allclose(g.numpy(), ref_g, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] + 1e-4 * np.abs(ref_g).max(),
                                   err_msg=name)


def test_forward_and_generate_match_jax_bf16(small_dataset, monkeypatch):
    """The default compute dtype (bf16 matmuls); parameters f32 on both
    sides, the prior sample from the same injected noise."""
    cfg = _cfg(dtype="bfloat16", dec_type="pseudo2")
    jtr, jstate, tr = _pair(cfg, small_dataset)
    idx = np.arange(BATCH)
    jb = small_dataset.batch(idx)
    tb = _port_dataset(small_dataset).batch(idx)
    eps = np.random.default_rng(5).normal(size=(BATCH * 3, 16)).astype(np.float32)
    model = jtr.model
    ref = jax.jit(lambda p, b: model.apply({"params": p}, b, rngs={"sample": jax.random.PRNGKey(0)}))(
        jstate.params, jb)
    with monkeypatch.context() as mp:
        # cgvae.py draws the prior sample through jax.random.normal
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
        ref_gen = jax.jit(lambda p, b: model.apply(
            {"params": p}, b, method=model.generate,
            rngs={"sample": jax.random.PRNGKey(0)}))(jstate.params, jb)
    with torch.no_grad():
        out = tr.model(tb)
        gen = tr.model.generate(tb, eps=torch.as_tensor(eps))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).float().numpy(),
                                   np.asarray(getattr(ref, f), np.float32),
                                   **BF16_TOL, err_msg=f)
    np.testing.assert_allclose(gen.float().numpy(), np.asarray(ref_gen, np.float32),
                               **BF16_TOL)


def test_generate_matches_jax_f32(small_dataset, monkeypatch):
    cfg = _cfg(dec_type="pseudo")
    jtr, jstate, tr = _pair(cfg, small_dataset)
    jb = small_dataset.batch(np.arange(BATCH))
    tb = _port_dataset(small_dataset).batch(np.arange(BATCH))
    eps = np.random.default_rng(6).normal(size=(BATCH * 3, 16)).astype(np.float32)
    model = jtr.model
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
        ref = jax.jit(lambda p, b: model.apply(
            {"params": p}, b, method=model.generate,
            rngs={"sample": jax.random.PRNGKey(0)}))(jstate.params, jb)
    with torch.no_grad():
        # eps may come shaped (B, M, F), as DenseCGVAE takes it
        got = tr.model.generate(tb, eps=torch.as_tensor(eps).reshape(BATCH, 3, 16))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)


def test_epoch_program_equals_eager_epoch(small_dataset):
    """The static-buffer epoch program (what a card captures and replays;
    here the static step in a loop) against the eager epoch from the same
    parameters, moments and generator: the same bits, with sampling noise
    on (det=False) and the radius graphs gathered from the device
    dataset."""
    cfg = _cfg(dec_type="pseudo")
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, det=False))
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    tr = Trainer(CGequiVAE(tc.model, generator=torch.Generator().manual_seed(0)), tc,
                 device="cpu")
    tds = _port_dataset(small_dataset)
    dds = DeviceDataset.from_dataset(tds.subset(np.arange(16)), "cpu")
    state = tr.init_state(tds.batch(np.arange(BATCH)))
    start = {k: p.detach().clone() for k, p in state.params.items()}
    batches = epoch_index_batches(dds.n_frames, BATCH, np.random.default_rng(1))
    runs = []
    for program in (False, True):
        with torch.no_grad():
            for k, p in state.params.items():
                p.copy_(start[k])
        st = tr.init_state(tds.batch(np.arange(BATCH)))
        gen = torch.Generator().manual_seed(3)
        if program:
            st, m = tr._run_program(st, dds, batches, gen, True, False)
        else:
            idx = torch.as_tensor(batches, dtype=torch.long)
            st, m = tr._run_batches(st, (dds.gather(i) for i in idx), gen, True)
        runs.append(([p.detach().clone() for p in st.params.values()],
                     st.opt_state.mu.clone(), m))
    (p_e, mu_e, m_e), (p_p, mu_p, m_p) = runs
    assert m_e["n_steps"] == m_p["n_steps"] == len(batches)
    assert m_e == m_p and torch.equal(mu_e, mu_p)
    assert all(torch.equal(a, b) for a, b in zip(p_e, p_p))
    assert any(not torch.equal(a, start[k]) for a, k in zip(p_e, start))


@pytest.mark.parametrize("block", ["PseudoUpdateBlock", "InvariantFilter"])
def test_unused_blocks_match_jax(block):
    """The two blocks no decoder calls (the original code builds the pseudo
    update but comments its call out; the filter is a helper): outputs on
    the same inputs and weights at f32."""
    from coarsegrainingvae_tpu.models import conv as jconv
    from coarsegrainingvae_tpu_torch.models import conv as tconv

    f, n = 8, 5
    rng = np.random.default_rng(7)
    s = rng.normal(size=(n, f)).astype(np.float32)
    v = rng.normal(size=(n, 3, f)).astype(np.float32)
    if block == "PseudoUpdateBlock":
        jmod, args = jconv.PseudoUpdateBlock(feat_dim=f, activation="swish"), (s, v)
        tmod = tconv.PseudoUpdateBlock(f, "swish")
        names = {"u": "Dense_0", "v": "Dense_1", "gate": "Dense_2", "split": "Dense_3"}
    else:
        jmod, args = jconv.InvariantFilter(feat_dim=f), (s,)
        tmod = tconv.InvariantFilter(f)
        names = {"dense": "Dense_0"}
    params = jax.device_get(jmod.init(jax.random.PRNGKey(0), *args)["params"])
    state = {}
    for dst, src in names.items():
        leaf = params[src]["Dense_0"]
        state[f"{dst}.weight"] = torch.as_tensor(np.asarray(leaf["kernel"]).T.copy())
        if "bias" in leaf:
            state[f"{dst}.bias"] = torch.as_tensor(np.array(leaf["bias"]))
    tmod.load_state_dict(state)
    ref = jmod.apply({"params": params}, *args)
    with torch.no_grad():
        out = tmod(*(torch.as_tensor(a) for a in args))
    assert len(out) == len(ref)
    for o, r in zip(out, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), **F32_TOL)
