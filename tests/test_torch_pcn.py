"""PCN and StochasticPCN of the PyTorch port against the JAX package's, on
the same padded protein batches and the same converted parameters: the
forward per decoder, with and without C-alpha recentring, at f32 and at
the bf16 default; one step's gradients and update with the ramped
auxiliary and steric terms and the rooted bond projection; the projection
itself; the stochastic model with injected noise; the trainer's ``fit``;
``run_pcn`` beside the JAX CLI; and ``segment_softmax``.

Both packages run on the CPU, the JAX side jitted. PCN runs no Pallas
kernel in either package (segment sums only).
"""
import csv
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import ModelConfig
from coarsegrainingvae_tpu.data import sidechain as jsc
from coarsegrainingvae_tpu.data.synthetic import synthetic_protein
from coarsegrainingvae_tpu.models import cgvae as jcgvae
from coarsegrainingvae_tpu.ops.segment import segment_softmax as jsegment_softmax
from coarsegrainingvae_tpu.train.losses import kl_divergence as jkl
from coarsegrainingvae_tpu.train.pcn_trainer import PCNTrainer as JaxPCNTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.cli import run_pcn
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.utils import flax_msgpack
from coarsegrainingvae_tpu_torch.data import sidechain
from coarsegrainingvae_tpu_torch.models.cgvae import (
    PCN,
    StochasticPCN,
    flatten_batch,
    project_bonds_rooted,
)
from coarsegrainingvae_tpu_torch.ops.segment import segment_softmax
from coarsegrainingvae_tpu_torch.train import pcn_trainer
from coarsegrainingvae_tpu_torch.train.losses import kl_divergence
from coarsegrainingvae_tpu_torch.train.pcn_trainer import PCNTrainer

torch.set_num_threads(1)

BATCH = 4
# f32: the same arithmetic summed in another order (segment sums, flax vs
# torch matmuls)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both sides round every Dense input, weight and output to bf16
# (relative step 2^-8); XLA and torch accumulate the bf16 matmuls and
# segment sums differently, so elements differ by a bf16 step or two at
# O(1) magnitudes, as in tests/test_torch_sparse.py. Coordinates are
# offsets of O(1) added to C-alpha positions of O(10-30) A, so the bound is
# absolute.
BF16_TOL = dict(rtol=0, atol=5e-2)
DECODERS = ("cross", "painn", "pseudo", "pseudo2")


@pytest.fixture(scope="module")
def data():
    """Four synthetic proteins of 6-14 residues, one with missing side-chain
    atoms: the JAX dataset, the port's, and one batch of all four."""
    items = [synthetic_protein(n, seed=s) for n, s in ((6, 0), (9, 1), (14, 2))]
    items.append(synthetic_protein(11, seed=3, missing_frac=0.3))
    jds = jsc.build_pcn_dataset(items, cg_cutoff=10.0)
    tds = sidechain.build_pcn_dataset(items, cg_cutoff=10.0)
    idx = np.arange(BATCH)
    return jds, tds, jds.batch(idx), tds.batch(idx), jds.ca_mask_for(idx), \
        jds.dihedrals_for(idx)


def _cfg(dec_type="cross", dtype="float32", **kw):
    return ModelConfig(n_basis=16, n_rbf=5, atom_cutoff=10.0, dec_nconv=2, enc_nconv=1,
                       activation="swish", dec_type=dec_type, compute_dtype=dtype, **kw)


def _pair(jb, cam, cfg, stochastic=False, ca_recenter=True):
    """The JAX model and parameters, and the port's model on the converted
    parameters."""
    jm = (jcgvae.StochasticPCN if stochastic else jcgvae.PCN)(cfg=cfg, ca_recenter=ca_recenter)
    params = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                     jb, jnp.asarray(cam))["params"]
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    tm = (StochasticPCN if stochastic else PCN)(tc, ca_recenter=ca_recenter)
    tm.load_state_dict(convert_flax_params(jax.device_get(params), tc))
    return jm, params, tm


def _fixed_normal(eps):
    return lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype).reshape(shape)


@pytest.mark.parametrize("ca_recenter", [True, False])
@pytest.mark.parametrize("dec_type", DECODERS)
def test_pcn_forward_matches_jax_f32(data, dec_type, ca_recenter):
    _, _, jb, tb, cam, _ = data
    jm, params, tm = _pair(jb, cam, _cfg(dec_type), ca_recenter=ca_recenter)
    ref = jax.jit(lambda p, b, c: jm.apply({"params": p}, b, c))(params, jb, jnp.asarray(cam))
    with torch.no_grad():
        out = tm(tb, torch.as_tensor(cam))
    np.testing.assert_allclose(out.xyz_recon.numpy(), np.asarray(ref.xyz_recon), **F32_TOL)
    np.testing.assert_array_equal(out.xyz.numpy(), np.asarray(ref.xyz))


@pytest.mark.parametrize("dec_type", ["cross", "pseudo2"])
def test_pcn_forward_matches_jax_bf16(data, dec_type):
    _, _, jb, tb, cam, _ = data
    jm, params, tm = _pair(jb, cam, _cfg(dec_type, dtype="bfloat16"))
    ref = jax.jit(lambda p, b, c: jm.apply({"params": p}, b, c))(params, jb, jnp.asarray(cam))
    with torch.no_grad():
        out = tm(tb, torch.as_tensor(cam))
    np.testing.assert_allclose(out.xyz_recon.float().numpy(),
                               np.asarray(ref.xyz_recon, np.float32), **BF16_TOL)


TRAIN_KW = dict(gamma=5.0, kappa=1.0, lr=3e-3, grad_clip=1.0, zeta=20.0, zeta_warmup=10,
                bond_project=True)


def test_pcn_step_gradients_and_update_match_jax(data):
    """aux_scale 0.5, zeta half-way up its ramp (step 5 of 10) and the
    rooted bond projection in the loss: the loss terms, every parameter's
    gradient, and the parameters after one clipped Adam step."""
    _, _, jb, tb, cam, (quads, qmask) = data
    jm, params, tm = _pair(jb, cam, _cfg("cross"))
    jtr = JaxPCNTrainer(jm, **TRAIN_KW)
    tr = PCNTrainer(tm, device="cpu", **TRAIN_KW)
    args = (jb, jnp.asarray(cam), jnp.asarray(quads), jnp.asarray(qmask))

    (_, jm_), jgrads = jax.jit(jax.value_and_grad(
        lambda p, *a: jtr._loss(p, *a, 0.5, jnp.float32(0.5)), has_aux=True))(params, *args)
    state = tr.init_state()
    state.step = 5
    b, c, q, qm = tr._inputs(tb, cam, quads, qmask)
    loss, metrics = tr._loss(b, c, q, qm, 0.5, tr.zeta_at(state.step))
    assert set(metrics) == set(jm_) == {"loss", "recon", "graph", "dihe", "steric"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jm_[k]), rtol=1e-4, err_msg=k)
    names = list(state.params)
    got = torch.autograd.grad(loss, [state.params[k] for k in names])
    want = convert_flax_params(jax.device_get(jgrads), tr.model.cfg)
    assert set(names) == set(want)
    for name, g in zip(names, got):
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] + 1e-4 * np.abs(ref).max(), err_msg=name)

    jstate = _jax_state(jtr, params, step=5)
    jnew, _ = jax.jit(jtr._train_step_impl)(jstate, *args, jnp.float32(0.5))
    state, _ = tr.train_step(state, tb, cam, quads, qmask, 0.5)
    assert state.step == 6
    want = convert_flax_params(jax.device_get(jnew.params), tr.model.cfg)
    for name, p in state.params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] + 1e-4 * np.abs(ref).max(), err_msg=name)


def _jax_state(jtr, params, step=0):
    from coarsegrainingvae_tpu.train.pcn_trainer import PCNTrainState

    return PCNTrainState(params=params, opt_state=jtr.tx.init(params),
                         step=jnp.asarray(step, jnp.int32),
                         lr=jnp.asarray(jtr.base_lr, jnp.float32))


def test_project_bonds_rooted_matches_jax_and_repeats_its_bits(data):
    _, _, jb, tb, cam, _ = data
    g, jg = flatten_batch(tb), jcgvae.flatten_batch(jb)
    noisy = (np.asarray(jg.xyz) + np.random.default_rng(1).normal(
        scale=0.5, size=jg.xyz.shape)).astype(np.float32)
    root = np.asarray(cam).reshape(-1)
    ref = jax.jit(jcgvae.project_bonds_rooted)(jnp.asarray(noisy), jg.xyz, jg.bonds,
                                               jg.bond_mask, jnp.asarray(root), jg.atom_mask)
    args = (torch.as_tensor(noisy), g.xyz, g.bonds, g.bond_mask, torch.as_tensor(root),
            g.atom_mask)
    got = project_bonds_rooted(*args)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **F32_TOL)
    np.testing.assert_array_equal(project_bonds_rooted(*args).numpy(), got.numpy())
    # the roots stay put and padding atoms are untouched
    keep = root | ~g.atom_mask.numpy()
    np.testing.assert_array_equal(got.numpy()[keep], noisy[keep])


def test_stochastic_pcn_matches_jax_with_injected_noise(data, monkeypatch):
    """forward (all five outputs), reconstruct_mean and generate from the
    same noise, and the KL term, in the model and in the trainer's loss."""
    _, _, jb, tb, cam, (quads, qmask) = data
    jm, params, tm = _pair(jb, cam, _cfg("pseudo2"), stochastic=True)
    shape = (BATCH * jb.cg_z.shape[1], 16)
    eps = np.random.default_rng(5).normal(size=shape).astype(np.float32)
    c = jnp.asarray(cam)
    with monkeypatch.context() as mp:
        mp.setattr(jax.random, "normal", _fixed_normal(eps))
        ref = jm.apply({"params": params}, jb, c, rngs={"sample": jax.random.PRNGKey(0)})
        ref_gen = jm.apply({"params": params}, jb, c, method="generate",
                           rngs={"sample": jax.random.PRNGKey(0)})
        jtr = JaxPCNTrainer(jm, gamma=1.0, kappa=0.5, beta=0.05)
        _, jmetrics = jtr._loss(params, jb, c, jnp.asarray(quads), jnp.asarray(qmask))
    ref_mean = jm.apply({"params": params}, jb, c, method="reconstruct_mean")
    ct, et = torch.as_tensor(cam), torch.as_tensor(eps)
    with torch.no_grad():
        out = tm(tb, ct, eps=et)
        gen = tm.generate(tb, ct, eps=et)
        mean = tm.reconstruct_mean(tb, ct)
    for f in ("mu", "sigma", "prior_mu", "prior_sigma", "xyz_recon"):
        np.testing.assert_allclose(getattr(out, f).numpy(), np.asarray(getattr(ref, f)),
                                   **F32_TOL, err_msg=f)
    np.testing.assert_allclose(gen.numpy(), np.asarray(ref_gen), **F32_TOL)
    np.testing.assert_allclose(mean.numpy(), np.asarray(ref_mean), **F32_TOL)
    g = flatten_batch(tb)
    kl = kl_divergence(out.mu, out.sigma, out.prior_mu, out.prior_sigma, mask=g.cg_mask)
    want = jkl(ref.mu, ref.sigma, ref.prior_mu, ref.prior_sigma,
               mask=jcgvae.flatten_batch(jb).cg_mask)
    np.testing.assert_allclose(kl.item(), float(want), rtol=1e-4)

    tr = PCNTrainer(tm, gamma=1.0, kappa=0.5, beta=0.05, device="cpu")
    tm.forward = lambda batch, ca_mask=None, eps=None, generator=None: StochasticPCN.forward(
        tm, batch, ca_mask, eps=et)
    b, c2, q, qm = tr._inputs(tb, cam, quads, qmask)
    with torch.no_grad():
        _, metrics = tr._loss(b, c2, q, qm)
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        np.testing.assert_allclose(metrics[k].item(), float(jmetrics[k]), rtol=1e-4, err_msg=k)


def _stochastic_step_grads(data, dec_type, kw, dtype=torch.float32):
    """JAX's and the port's loss metrics and per-parameter gradients of the
    StochasticPCN objective (aux_scale 0.5, zeta half-way up its ramp) from
    the same injected noise; the port's at ``dtype`` (the model, the
    coordinates and the noise), JAX's at f32."""
    _, _, jb, tb, cam, (quads, qmask) = data
    jm, params, tm = _pair(jb, cam, _cfg(dec_type), stochastic=True)
    eps = np.random.default_rng(6).normal(size=(BATCH * jb.cg_z.shape[1], 16)).astype(
        np.float32)
    jtr = JaxPCNTrainer(jm, **kw)
    args = (jb, jnp.asarray(cam), jnp.asarray(quads), jnp.asarray(qmask))
    normal = jax.random.normal
    jax.random.normal = _fixed_normal(eps)
    try:
        (_, jmetrics), jgrads = jax.value_and_grad(
            lambda p, *a: jtr._loss(p, *a, 0.5, jnp.float32(0.5)), has_aux=True)(params, *args)
    finally:
        jax.random.normal = normal
    if dtype == torch.float64:
        tm = tm.double()
        tb = dataclasses.replace(tb, xyz=tb.xyz.double(), cg_xyz=tb.cg_xyz.double())
    et = torch.as_tensor(eps, dtype=dtype)
    tm.forward = lambda batch, ca_mask=None, eps=None, generator=None: StochasticPCN.forward(
        tm, batch, ca_mask, eps=et)
    tr = PCNTrainer(tm, device="cpu", **kw)
    state = tr.init_state()
    b, c, q, qm = tr._inputs(tb, cam, quads, qmask)
    loss, metrics = tr._loss(b, c, q, qm, 0.5, tr.zeta_at(5))
    names = list(state.params)
    got = torch.autograd.grad(loss, [state.params[k] for k in names], allow_unused=True)
    got = [torch.zeros_like(state.params[k]) if g is None else g for k, g in zip(names, got)]
    want = convert_flax_params(jax.device_get(jgrads), tr.model.cfg)
    assert set(names) == set(want)
    return metrics, jmetrics, dict(zip(names, got)), want


def _worst_rel(got, want):
    """max over parameters of max|got - want| / max|want|."""
    return max((got[k].double() - want[k].double()).abs().max().item()
               / max(want[k].abs().max().item(), 1e-30) for k in want)


@pytest.mark.parametrize("dec_type", ["cross", "pseudo2"])
def test_stochastic_pcn_step_gradients_match_jax(data, dec_type):
    """beta * KL with the recon, graph and ramped steric terms, from the
    same injected noise: the loss terms and every parameter's gradient
    (encoder, munet, sigmanet, latent_mix, prior and decoder) at f32. The
    dihedral term and the rooted projection are off here: at random
    weights their f32 gradients sit 1e-3 from float64 in both packages
    (the test below holds them)."""
    kw = dict(TRAIN_KW, beta=0.05, kappa=0.0, bond_project=False)
    metrics, jmetrics, got, want = _stochastic_step_grads(data, dec_type, kw)
    assert set(metrics) == set(jmetrics) == {"loss", "recon", "graph", "dihe", "steric", "kl"}
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    for part in ("atom_embedding", "enc_contract", "enc_msgs", "enc_upds", "munet", "sigmanet",
                 "latent_mix", "prior_net"):
        assert any(k.startswith(part) and want[k].abs().max() > 0 for k in got), part
    for name, g in got.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=F32_TOL["rtol"],
                                   atol=F32_TOL["atol"] + 1e-4 * np.abs(ref).max(), err_msg=name)


@pytest.mark.parametrize("dec_type", ["cross", "pseudo2"])
def test_stochastic_pcn_whole_objective_gradients_within_f32_conditioning(data, dec_type):
    """The whole objective (beta * KL, the dihedral term, the rooted
    projection). Its f32 gradients at random weights are ill-conditioned:
    the projection divides by decoded bond lengths near zero and the
    dihedral's atan2 has near-degenerate quads, so JAX's own f32 gradients
    sit ~4e-3 (max|err|/max|ref|) from the port's float64 ones. The port's
    f32 gradients must be no farther from float64 than twice JAX's, and
    nearer to JAX's than JAX's are to float64; the loss terms agree at
    rtol 1e-4."""
    kw = dict(TRAIN_KW, beta=0.05)
    metrics, jmetrics, got, want = _stochastic_step_grads(data, dec_type, kw)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(jmetrics[k]), rtol=1e-4, err_msg=k)
    _, _, exact, _ = _stochastic_step_grads(data, dec_type, kw, torch.float64)
    want = {k: torch.as_tensor(v) for k, v in want.items()}
    jax_err = _worst_rel(want, exact)
    assert _worst_rel(got, exact) <= 2.0 * jax_err
    assert _worst_rel(got, want) <= jax_err


def test_sample_ensemble(data):
    _, _, jb, tb, cam, _ = data
    tc = tcfg.ModelConfig(**dataclasses.asdict(_cfg("cross")))
    with pytest.raises(ValueError, match="StochasticPCN"):
        PCNTrainer(PCN(tc), device="cpu").sample_ensemble(tb, cam, 2)
    tr = PCNTrainer(StochasticPCN(tc, generator=torch.Generator().manual_seed(0)),
                    bond_project_eval=True, device="cpu")
    ens = tr.sample_ensemble(tb, cam, 3, seed=4)
    assert ens.shape == (3, tb.z.numel(), 3)
    assert torch.isfinite(ens).all()
    assert (ens[0] - ens[1]).abs().max() > 1e-5
    np.testing.assert_array_equal(tr.sample_ensemble(tb, cam, 3, seed=4).numpy(), ens.numpy())


JAX_HISTORY = ["epoch", "lr", "train_loss", "val_loss", "train_recon", "val_recon",
               "train_graph", "val_graph", "train_dihe", "val_dihe", "epoch_time_s"]


def test_fit_returns_the_best_val_parameters_and_holds_through_warmup(data, monkeypatch):
    _, tds, _, _, _, _ = data
    controller_calls = []

    class Recording(pcn_trainer.LowessPlateauController):
        def step(self, val_loss):
            controller_calls.append(val_loss)
            return super().step(val_loss)

    monkeypatch.setattr(pcn_trainer, "LowessPlateauController", Recording)
    tc = tcfg.ModelConfig(**dataclasses.asdict(_cfg("cross")))
    tr = PCNTrainer(StochasticPCN(tc, generator=torch.Generator().manual_seed(0)), gamma=5.0,
                    kappa=1.0, lr=5e-2, grad_clip=1.0, aux_warmup=2, beta=0.05, device="cpu")
    state = tr.init_state()
    snapshots = []

    def log(row):
        snapshots.append({k: p.detach().clone() for k, p in state.params.items()})

    state, hist = tr.fit(state, tds.subset(np.arange(2)), tds.subset(np.arange(2, 4)),
                         nepochs=4, batch_size=2, log_fn=log)
    assert [list(r) for r in hist] == [JAX_HISTORY + ["train_kl", "val_kl"]] * len(hist)
    assert len(controller_calls) == len(hist) - 2        # held through 2 warm-up epochs
    best = int(np.nanargmin([r["val_loss"] for r in hist]))
    for k, p in state.params.items():
        torch.testing.assert_close(p.detach(), snapshots[best][k], rtol=0, atol=0)
    assert state.step == 4


def _read_csv(path):
    with open(path) as f:
        rows = list(csv.DictReader(f))
    return list(rows[0]), rows


CLI_FLAGS = ["-ndata", "10", "-n_basis", "16", "-n_rbf", "5", "-dec_nconv", "1", "-nepochs", "2",
             "-batch_size", "2", "-n_dump", "2", "-zeta", "20", "-zeta_warmup", "4",
             "-aux_warmup", "1", "--bond_project"]


def test_run_pcn_artifacts_match_the_jax_cli(tmp_path):
    from coarsegrainingvae_tpu.cli.run_pcn import main as jax_main

    stoch = ["--stochastic", "-n_ensemble", "3"]
    jax_main(CLI_FLAGS + stoch + ["-logdir", str(tmp_path / "jax")])
    run_pcn.main(CLI_FLAGS + stoch + ["-logdir", str(tmp_path / "port_s"), "--device", "cpu"])
    run_pcn.main(CLI_FLAGS + ["-logdir", str(tmp_path / "port"), "--device", "cpu"])
    (jdir,) = tmp_path.glob("jax_*")
    (sdir,) = tmp_path.glob("port_s_*")
    (ddir,) = [d for d in tmp_path.glob("port_*") if d != sdir]
    jnames = sorted(p.name for p in jdir.iterdir())
    assert "params.msgpack" in jnames
    assert sorted(p.name for p in sdir.iterdir()) == jnames
    assert sorted(p.name for p in ddir.iterdir()) == jnames
    assert sdir.name[len("port_s"):] == jdir.name[len("jax"):]

    jparams = json.loads((jdir / "modelparams.json").read_text())
    sparams = json.loads((sdir / "modelparams.json").read_text())
    assert set(sparams) - set(jparams) == {"device"} and set(jparams) <= set(sparams)

    sample_cols = ["sample_best_rmsd", "sample_mean_rmsd"]
    kl_cols = ["train_kl", "val_kl"]
    for name, drop in (("test_results.csv", sample_cols), ("train_log.csv", kl_cols)):
        jhead, _ = _read_csv(jdir / name)
        shead, srows = _read_csv(sdir / name)
        dhead, drows = _read_csv(ddir / name)
        assert shead == jhead, name
        assert dhead == [c for c in jhead if c not in drop], name
        for row in srows + drows:
            assert all(np.isfinite(float(v)) for v in row.values()), (name, row)
    tree = flax_msgpack.loads((sdir / "params.msgpack").read_bytes())
    assert set(tree) == set(flax_msgpack.loads((jdir / "params.msgpack").read_bytes()))
    assert "latent_mix" in tree


@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(masked):
    rng = np.random.default_rng(3)
    ids = np.sort(rng.integers(0, 6, size=40))               # segment 5 may be empty
    logits = rng.normal(size=40).astype(np.float32) * 3.0
    mask = rng.random(40) > 0.3 if masked else None
    want = jsegment_softmax(jnp.asarray(logits), jnp.asarray(ids), 7,
                            None if mask is None else jnp.asarray(mask))
    got = segment_softmax(torch.as_tensor(logits), torch.as_tensor(ids), 7,
                          None if mask is None else torch.as_tensor(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
