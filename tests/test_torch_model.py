"""Whole-model parity: the PyTorch port's DenseCGVAE against the JAX
DenseCGVAE on the same batch and the same converted parameters.

The JAX side runs its Pallas kernels in interpret mode on the CPU
(message_impl / pseudo_impl = "pallas") and, at f32, also its default
einsum / stacked formulations, whose pseudo parameter tree is the other one
convert_flax_params accepts. The port runs its kernels' plain versions (the
tensors are on the CPU).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.config import ModelConfig
from coarsegrainingvae_tpu.data.batch import CGBatch as JaxBatch
from coarsegrainingvae_tpu.data.mappings import newman_mapping
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu.data.topology import channel_index_from_mapping
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu_torch.config import ModelConfig as TorchConfig
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.batch import CGBatch as TorchBatch
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE as TorchModel

torch.set_num_threads(1)

B, M, F = 2, 3, 24
FIELDS = ("mu", "sigma", "prior_mu", "prior_sigma", "xyz", "xyz_recon")
# f32: the same arithmetic summed in another order (einsum vs fused sums,
# flax vs torch matmuls); the tolerance of tests/test_pallas_pseudo.py:74-76
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# bf16: both sides round every Dense input, weight, product and activation
# to bf16 (8 significant bits, relative step 2^-8 = 3.9e-3), but XLA and
# torch accumulate and round the bf16 matmuls differently, so single
# elements differ by a bf16 step (one step is 0.0156 at magnitude 2-4, the
# largest difference seen here). Outputs are O(1); 2e-2 absolute plus 2e-2
# relative allows a couple of steps, still far below the differences a
# wrong layer, cast or parameter mapping makes (O(1)).
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _cfg(impl: str, dtype: str = "float32", dec_type: str = "pseudo") -> ModelConfig:
    kw = dict(message_impl="pallas", pseudo_impl="pallas") if impl == "pallas" else {}
    return ModelConfig(n_cgs=M, n_basis=F, n_rbf=5, atom_cutoff=8.5, cg_cutoff=9.5,
                       enc_nconv=2, dec_nconv=2, activation="swish",
                       dec_type=dec_type, breaksym=True, det=True,
                       compute_dtype=dtype, **kw)


@pytest.fixture(scope="module")
def batches():
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=B, seed=0)
    mapping = newman_mapping(bonds, z.shape[0], M, seed=0)
    n = z.shape[0]
    cg = np.stack([frames[:, mapping == k].mean(1) for k in range(M)], 1)
    mask = np.ones((B, n), bool)
    mask[1, -1] = False        # one padded atom row in the second sample
    arrs = dict(
        z=np.tile(z, (B, 1)).astype(np.int32), xyz=frames, atom_mask=mask,
        cg_z=np.tile(np.arange(M, dtype=np.int32), (B, 1)), cg_xyz=cg,
        cg_mask=np.ones((B, M), bool),
        mapping=np.tile(mapping, (B, 1)).astype(np.int32),
        channel_idx=np.tile(channel_index_from_mapping(mapping), (B, 1)),
    )
    empty2, empty = jnp.zeros((B, 1, 2), jnp.int32), jnp.zeros((B, 1), bool)
    jb = JaxBatch(**{k: jnp.asarray(v) for k, v in arrs.items()},
                  nbrs=empty2, nbr_mask=empty, cg_nbrs=empty2,
                  cg_nbr_mask=empty, bonds=empty2, bond_mask=empty)
    tb = TorchBatch(**{k: torch.as_tensor(v).long() if v.dtype == np.int32
                       else torch.as_tensor(v) for k, v in arrs.items()})
    return jb, tb


def _init(cfg, jb):
    model = JaxModel(cfg=cfg)
    params = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jb
    )["params"]
    return jax.device_get(params)


@pytest.fixture(scope="module")
def params(batches):
    jb, _ = batches
    return {impl: _init(_cfg(impl), jb) for impl in ("pallas", "default")}


def _torch_model(cfg, params):
    tcfg = TorchConfig(**dataclasses.asdict(cfg))
    model = TorchModel(tcfg)
    model.load_state_dict(convert_flax_params(params, tcfg))
    return model.eval()


def _eps(seed=3):
    return np.random.default_rng(seed).normal(size=(B, M, F)).astype(np.float32)


def _jax_generate(cfg, params, jb, eps, monkeypatch):
    model = JaxModel(cfg=cfg)
    with monkeypatch.context() as mp:
        # dense_cgvae.py draws the prior sample through jax.random.normal
        mp.setattr(jax.random, "normal",
                   lambda key, shape, dtype=jnp.float32: jnp.asarray(eps, dtype))
        out = jax.jit(lambda p, b: model.apply(
            {"params": p}, b, method=model.generate,
            rngs={"sample": jax.random.PRNGKey(0)}))(params, jb)
    return np.asarray(out, np.float32)


def _jax_forward(cfg, params, jb):
    model = JaxModel(cfg=cfg)
    out = jax.jit(lambda p, b: model.apply(
        {"params": p}, b, rngs={"sample": jax.random.PRNGKey(0)}))(params, jb)
    return {f: np.asarray(getattr(out, f), np.float32) for f in FIELDS}


@pytest.mark.parametrize("impl", ["pallas", "default"])
def test_forward_det_matches_jax_f32(batches, params, impl):
    jb, tb = batches
    cfg = _cfg(impl)
    ref = _jax_forward(cfg, params[impl], jb)
    with torch.inference_mode():
        out = _torch_model(cfg, params[impl])(tb)
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(), ref[f], **F32_TOL,
                                   err_msg=f)


@pytest.mark.parametrize("impl", ["pallas", "default"])
def test_generate_matches_jax_f32(batches, params, impl, monkeypatch):
    jb, tb = batches
    cfg = _cfg(impl)
    eps = _eps()
    ref = _jax_generate(cfg, params[impl], jb, eps, monkeypatch)
    with torch.inference_mode():
        out = _torch_model(cfg, params[impl]).generate(tb, eps=torch.as_tensor(eps))
    assert out.shape == (B * tb.n_atoms, 3)
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_forward_and_generate_match_jax_bf16(batches, params, monkeypatch):
    """The default compute dtype (bf16 matmuls), against the JAX kernel
    path that the port computes; parameters stay f32 on both sides."""
    jb, tb = batches
    cfg = _cfg("pallas", dtype="bfloat16")
    model = _torch_model(cfg, params["pallas"])
    ref = _jax_forward(cfg, params["pallas"], jb)
    eps = _eps()
    ref_gen = _jax_generate(cfg, params["pallas"], jb, eps, monkeypatch)
    with torch.inference_mode():
        out = model(tb)
        gen = model.generate(tb, eps=torch.as_tensor(eps))
    for f in FIELDS:
        np.testing.assert_allclose(getattr(out, f).float().numpy(), ref[f],
                                   **BF16_TOL, err_msg=f)
    np.testing.assert_allclose(gen.float().numpy(), ref_gen, **BF16_TOL)


def test_generate_never_runs_the_encoder(batches, params):
    """generate reads only the CG side: no encoder layer runs, and the
    same eps gives the same output."""
    _, tb = batches
    model = _torch_model(_cfg("pallas"), params["pallas"])
    calls = []
    for layer in model.enc_msgs:
        layer.register_forward_hook(lambda *a: calls.append("enc"))
    with torch.inference_mode():
        a = model.generate(tb, eps=torch.zeros(B, M, F))
        b = model.generate(tb, eps=torch.zeros(B, M, F))
    assert calls == []
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("dec_type", ["painn", "cross"])
def test_factored_decoders_match_jax_f32(batches, dec_type, monkeypatch):
    """dec_type painn / cross reuse the factored message block (S = 3 / 4)."""
    jb, tb = batches
    cfg = _cfg("default", dec_type=dec_type)
    p = _init(cfg, jb)
    eps = _eps()
    ref = _jax_generate(cfg, p, jb, eps, monkeypatch)
    with torch.inference_mode():
        out = _torch_model(cfg, p).generate(tb, eps=torch.as_tensor(eps))
    np.testing.assert_allclose(out.numpy(), ref, **F32_TOL)


def test_unported_options_raise():
    """pseudo2/en/inv exist only in the sparse CGequiVAE, so the dense model
    refuses them; the H projections build (their parity is
    tests/test_torch_steric.py's)."""
    for kw in (dict(h_project=True), dict(h_project_eval=True)):
        assert isinstance(TorchModel(TorchConfig(n_basis=8, **kw)), TorchModel)
    with pytest.raises(ValueError, match="dec_type"):
        TorchModel(TorchConfig(n_basis=8, dec_type="en"))

