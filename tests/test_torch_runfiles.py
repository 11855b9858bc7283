"""The JAX package's run files in the port: the flax msgpack codec against
flax, both directions of every parameter converter against JAX's trees,
the train state's Adam moments against JAX's ``opt_state``, the PCN and
DiffPool runs' ``params.msgpack`` loaded by JAX, and the refusal of an
orbax checkpoint directory.

Every JAX tree here has the structure, shapes and dtypes of the model's
``init`` (``jax.eval_shape``), filled with seeded random values: a leaf
that a converter swaps, transposes or splits wrongly shows, which the
zeros of an init's biases would hide.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from coarsegrainingvae_tpu import config as jcfg
from coarsegrainingvae_tpu.data import sidechain as jsc
from coarsegrainingvae_tpu.data.dataset import build_dataset
from coarsegrainingvae_tpu.data.diffpool import build_diffpool_dataset as jdiffpool_data
from coarsegrainingvae_tpu.data.mappings import newman_mapping
from coarsegrainingvae_tpu.data.neighbors import make_directed, radius_graph_dense
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide, synthetic_protein
from coarsegrainingvae_tpu.data.topology import channel_index_from_mapping
from coarsegrainingvae_tpu.models import baseline as jbl
from coarsegrainingvae_tpu.models import cgvae as jcgvae
from coarsegrainingvae_tpu.models import diffpool as jdp
from coarsegrainingvae_tpu.parallel import halo as jhalo
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch import convert
from coarsegrainingvae_tpu_torch.cli import run_diffpool, run_pcn
from coarsegrainingvae_tpu_torch.data import sidechain
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
from coarsegrainingvae_tpu_torch.models import baseline
from coarsegrainingvae_tpu_torch.models.cgvae import PCN, StochasticPCN, build_flagship_model
from coarsegrainingvae_tpu_torch.models.diffpool import DiffPoolVAE
from coarsegrainingvae_tpu_torch.parallel.halo import EquiStack
from coarsegrainingvae_tpu_torch.train.checkpoint import (
    CheckpointManager,
    OrbaxCheckpointError,
    _payload,
)
from coarsegrainingvae_tpu_torch.train.trainer import Trainer
from coarsegrainingvae_tpu_torch.utils import flax_msgpack

torch.set_num_threads(1)

F32_TOL = dict(rtol=1e-4, atol=1e-5)


# -------------------------------------------------------------------- codec
def _bf16(a):
    return np.asarray(jnp.asarray(a, jnp.bfloat16))


def _leaf_equal(got, want):
    """Same dtype name, shape and bits; bf16 arrives as a torch tensor."""
    if isinstance(got, torch.Tensor):
        assert got.dtype == torch.bfloat16 and want.dtype.name == "bfloat16"
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
        return
    assert type(got) is type(want) or isinstance(got, np.ndarray)
    assert np.asarray(got).dtype == np.asarray(want).dtype
    np.testing.assert_array_equal(got, want)


def _trees():
    rng = np.random.default_rng(0)
    f32 = rng.normal(size=(4, 5)).astype(np.float32)
    return {
        "f32": {"kernel": f32, "bias": f32[0].copy()},
        "bf16": {"x": _bf16(rng.normal(size=(3, 7)))},
        "int32": {"count": np.asarray(5, np.int32), "ids": np.arange(9, dtype=np.int32)},
        "zero_d": {"lr": np.asarray(3e-4, np.float32), "step": np.asarray(7, np.int64)},
        "scalars": {"a": np.float32(1.5), "b": np.int32(-3), "c": np.bool_(True),
                    "d": np.float64(2.0)},
        "native": {"i": 7, "neg": -70000, "big": 2**40, "f": 0.25, "t": True, "n": None,
                   "s": "x" * 40},
        "empty": {"e": {}, "nested": {"e": {}}},
        "deep": {"a": {"b": {"c": {"d": {"e": {"f": f32[:2]}}}}}},
        "many_keys": {f"k{i}": np.full((i,), i, np.float32) for i in range(20)},
        "odd_shapes": {"empty": np.zeros((0, 3), np.float32), "wide": np.ones((1, 300), np.uint8),
                       "long_bin": np.ones(70000, np.float32)},
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_codec_reads_what_flax_writes(name):
    tree = _trees()[name]
    data = serialization.msgpack_serialize(tree)
    got = flax_msgpack.loads(data)
    want = serialization.msgpack_restore(data)

    def walk(g, w):
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                walk(g[k], w[k])
        elif isinstance(w, (np.ndarray, np.generic)):
            _leaf_equal(g, w)
        else:
            assert type(g) is type(w) and g == w

    walk(got, want)
    assert flax_msgpack.dumps(got) == data       # read then re-written: the same bytes


@pytest.mark.parametrize("name", sorted(_trees()))
def test_flax_reads_what_the_codec_writes(name):
    tree = _trees()[name]
    data = flax_msgpack.dumps(tree)
    assert data == serialization.msgpack_serialize(tree)
    back = serialization.msgpack_restore(data)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(tree)
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        if isinstance(w, np.ndarray):
            assert g.dtype == w.dtype and g.shape == w.shape
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def test_codec_writes_torch_tensors_as_flax_arrays():
    """CPU tensors (bf16 included) write as the ndarrays they hold."""
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    b = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
    data = flax_msgpack.dumps({"t": t, "b": b})
    back = serialization.msgpack_restore(data)
    np.testing.assert_array_equal(back["t"], t.numpy())
    assert back["b"].dtype.name == "bfloat16"
    np.testing.assert_array_equal(np.asarray(back["b"], np.float32), [1.5, -2.0])
    assert data == serialization.msgpack_serialize({"t": t.numpy(), "b": _bf16([1.5, -2.0])})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_leaves_both_ways(monkeypatch, dtype):
    """flax's chunked form for leaves over MAX_CHUNK_SIZE bytes, forced with
    a chunk size of 64 bytes on both sides."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    a = np.random.default_rng(1).normal(size=(5, 9)).astype(np.float32)
    a = _bf16(a) if dtype == "bfloat16" else a
    tree = {"w": a, "small": np.ones(3, np.float32)}
    data = serialization.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    got = flax_msgpack.loads(data)
    _leaf_equal(got["w"], a)
    assert flax_msgpack.dumps(got) == data
    assert flax_msgpack.dumps(tree) == data
    back = serialization.msgpack_restore(flax_msgpack.dumps(got))
    np.testing.assert_array_equal(back["w"].view(np.uint8), a.view(np.uint8))


def test_codec_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        flax_msgpack.dumps({"x": object()})
    with pytest.raises(TypeError):
        flax_msgpack.dumps({"x": 1 - 2j})
    with pytest.raises(ValueError):
        flax_msgpack.loads(flax_msgpack.dumps({"a": 1}) + b"\x00")


# --------------------------------------------------------------- converters
def _fill(shapes, seed=0):
    """Random values of the dtype and shape of each leaf of ``shapes``."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda s: rng.normal(size=s.shape).astype(s.dtype), shapes)


def _plain(tree):
    return {k: _plain(v) if isinstance(v, dict) else v for k, v in tree.items()}


def _flax_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], dict):
            _flax_equal(got[k], want[k])
        else:
            g = got[k]
            if isinstance(g, torch.Tensor):      # bf16, which numpy lacks
                assert g.dtype == torch.bfloat16 and want[k].dtype.name == "bfloat16", k
                g = g.view(torch.int16).numpy().view(want[k].dtype)
            assert g.dtype == want[k].dtype and g.shape == want[k].shape, k
            np.testing.assert_array_equal(g.view(np.uint8), want[k].view(np.uint8), err_msg=k)


def _round_trips(tree, sd, to_port, to_flax):
    """to_flax(to_port(tree)) == tree; to_port(to_flax(sd)) == sd; the
    names to_port produces are the model's."""
    ported = to_port(tree)
    assert set(ported) == set(sd)
    for k, v in ported.items():
        assert v.shape == sd[k].shape and v.dtype == sd[k].dtype, k
    _flax_equal(to_flax(ported), tree)
    back = to_port(to_flax(sd))
    assert set(back) == set(sd)
    for k in sd:
        assert back[k].dtype == sd[k].dtype and torch.equal(back[k], sd[k]), k


@pytest.fixture(scope="module")
def dipeptide():
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=4, seed=0)
    mapping = newman_mapping(bonds, z.shape[0], 3, seed=0)
    ds = build_dataset(mapping, frames, atom_cutoff=8.5, cg_cutoff=9.5, atomic_nums=z,
                       bonds=bonds, order=2)
    return z, frames, bonds, mapping, ds


def _model_cfg(dec_type, sparse=False, pseudo_impl="stacked", **kw):
    return jcfg.ModelConfig(n_cgs=3, n_basis=8, n_rbf=3, enc_nconv=2, dec_nconv=2,
                            dec_type=dec_type, sparse=sparse, pseudo_impl=pseudo_impl, **kw)


FLAGSHIP = [("pseudo", False, "stacked"), ("pseudo", False, "pallas"), ("cross", False, "stacked"),
            ("painn", False, "stacked")] + [
    (d, True, "stacked") for d in ("pseudo", "pseudo2", "cross", "painn", "en", "inv")]


@pytest.mark.parametrize("dec_type,sparse,pseudo_impl", FLAGSHIP)
def test_flagship_converters_are_inverses(dipeptide, dec_type, sparse, pseudo_impl):
    """DenseCGVAE (each decoder, both pseudo trees) and CGequiVAE (each
    decoder) both ways."""
    cfg = _model_cfg(dec_type, sparse, pseudo_impl)
    jm = jcgvae.build_flagship_model(cfg)
    batch = dipeptide[4].batch(np.arange(2))
    tree = _plain(_fill(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, batch))["params"]))
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    sd = build_flagship_model(tc, generator=torch.Generator().manual_seed(0)).state_dict()
    _round_trips(tree, sd, lambda t: convert.convert_flax_params(t, tc),
                 lambda s: convert.to_flax_params(s, tc))


def test_non_equivariant_sparse_model_maps_its_euclidean_layer(dipeptide):
    cfg = _model_cfg("painn", True, equivariant=False)
    jm = jcgvae.build_flagship_model(cfg)
    batch = dipeptide[4].batch(np.arange(2))
    tree = _plain(_fill(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, batch))["params"]))
    assert "euclidean" in tree
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    sd = build_flagship_model(tc, generator=torch.Generator().manual_seed(0)).state_dict()
    _round_trips(tree, sd, lambda t: convert.convert_flax_params(t, tc),
                 lambda s: convert.to_flax_params(s, tc))


@pytest.fixture(scope="module")
def proteins():
    items = [synthetic_protein(n, seed=s) for n, s in ((6, 0), (8, 1))]
    return items, jsc.build_pcn_dataset(items, cg_cutoff=10.0)


@pytest.mark.parametrize("stochastic", [False, True])
@pytest.mark.parametrize("dec_type", ["cross", "pseudo2"])
def test_pcn_converters_are_inverses(proteins, stochastic, dec_type):
    _, jds = proteins
    cfg = jcfg.ModelConfig(n_basis=8, n_rbf=3, atom_cutoff=10.0, dec_nconv=2, enc_nconv=1,
                           dec_type=dec_type)
    jm = (jcgvae.StochasticPCN if stochastic else jcgvae.PCN)(cfg=cfg)
    idx = np.arange(2)
    tree = _plain(_fill(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)}, jds.batch(idx),
        jnp.asarray(jds.ca_mask_for(idx))))["params"]))
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    sd = (StochasticPCN if stochastic else PCN)(tc).state_dict()
    _round_trips(tree, sd, lambda t: convert.convert_flax_params(t, tc),
                 lambda s: convert.to_flax_params(s, tc))


N_DP_ATOMS, N_DP_CGS = 27, 4


@pytest.mark.parametrize("mode", ["trainable_map", "logits", "fixed"])
def test_diffpool_converters_are_inverses(dipeptide, mode):
    z, frames, bonds, _, _ = dipeptide
    jb = jdiffpool_data(frames, z, bonds).batch(np.arange(2))
    cfg = jcfg.DiffPoolConfig(n_atoms=N_DP_ATOMS, n_cgs=N_DP_CGS, feat_dim=8, n_rbf=3,
                              enc_nconv=2, dec_nconv=2, trainable_map=mode == "trainable_map")
    assign = tuple(i % N_DP_CGS for i in range(N_DP_ATOMS)) if mode == "fixed" else None
    jm = jdp.DiffPoolVAE(cfg=cfg, assign_idx=assign)
    tree = _plain(_fill(jax.eval_shape(lambda: jm.init(
        {"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
         "sample": jax.random.PRNGKey(2)}, jnp.asarray(jb.z), jnp.asarray(jb.xyz),
        jnp.asarray(jb.adj), jnp.asarray(cfg.tau_0)))["params"]))
    tc = tcfg.DiffPoolConfig(**dataclasses.asdict(cfg))
    sd = DiffPoolVAE(tc, assign).state_dict()
    _round_trips(tree, sd, lambda t: convert.convert_diffpool_params(t, tc),
                 lambda s: convert.diffpool_to_flax(s, tc))


ZOO = ("linear", "mlp", "equimlp", "equimlp2", "setequimlp", "edgesetmlp", "equilinear")


@pytest.mark.parametrize("name", ZOO)
def test_baseline_converters_are_inverses(dipeptide, name):
    z, frames, _, mapping, _ = dipeptide
    kw = {}
    if name in ("equimlp", "equimlp2", "setequimlp"):
        kw = dict(knn=2, width=2, depth=2, activation="ReLU")
    elif name == "mlp":
        kw = dict(width=2, depth=2, activation="ReLU")
    elif name in ("edgesetmlp", "equilinear"):
        kw = dict(knn=2)
    if name == "setequimlp":
        from coarsegrainingvae_tpu_torch.data import topology
        kw.update(channel_idx=channel_index_from_mapping(mapping),
                  n_channels=topology.max_atoms_per_bead(mapping))
    jm = jbl.build_baseline(name, 3, z.shape[0], mapping, **kw)
    tree = _plain(_fill(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(frames[:2])))["params"]))
    sd = baseline.build_baseline(name, 3, z.shape[0], mapping, **kw).state_dict()
    _round_trips(tree, sd, lambda t: convert.convert_baseline_params(t, name),
                 lambda s: convert.baseline_to_flax(s, name))


def test_equistack_converters_are_inverses():
    rng = np.random.default_rng(0)
    xyz = rng.uniform(0, 6, (12, 3)).astype(np.float32)
    edges = make_directed(radius_graph_dense(xyz, 4.0))
    kw = dict(n_conv=2, feat_dim=8, n_rbf=3, activation="swish", cutoff=4.0)
    s = rng.normal(size=(12, 8)).astype(np.float32)
    v = rng.normal(size=(12, 3, 8)).astype(np.float32)
    tree = _plain(_fill(jax.eval_shape(lambda: jhalo.EquiStack(**kw).init(
        jax.random.PRNGKey(0), s, v, jnp.asarray(xyz), jnp.asarray(edges), None))["params"]))
    sd = EquiStack(**kw).state_dict()
    _round_trips(tree, sd, lambda t: convert.convert_equistack_params(t, 2),
                 lambda s_: convert.equistack_to_flax(s_, 2))


def test_converters_refuse_a_leftover_or_missing_leaf(dipeptide):
    cfg = _model_cfg("pseudo")
    tc = tcfg.ModelConfig(**dataclasses.asdict(cfg))
    sd = build_flagship_model(tc).state_dict()
    tree = convert.to_flax_params(sd, tc)
    tree["stray"] = {"kernel": np.zeros(2, np.float32)}
    with pytest.raises(ValueError, match="stray"):
        convert.convert_flax_params(tree, tc)
    del sd["atom_embed.weight"]
    with pytest.raises(ValueError, match="atom_embed.weight"):
        convert.to_flax_params(sd, tc)


def test_the_inverse_writes_the_pseudo_tree_the_config_names(dipeptide):
    tc = tcfg.ModelConfig(**dataclasses.asdict(_model_cfg("pseudo")))
    sd = build_flagship_model(tc).state_dict()
    stacked = convert.to_flax_params(sd, tc)
    pallas = convert.to_flax_params(sd, dataclasses.replace(tc, pseudo_impl="pallas"))
    assert "DenseInvariantMessage_0" in stacked["DenseEquiMessagePseudo_0"]
    assert set(pallas["DenseEquiMessagePseudo_0"]) == {"Dense_0", "Dense_1", "filter_w"}
    for tree in (stacked, pallas):
        back = convert.convert_flax_params(tree, tc)
        assert all(torch.equal(back[k], sd[k]) for k in sd)


# ------------------------------------------------------------------ moments
BATCH = 8


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
def test_train_state_moments_match_jax_after_two_steps(small_dataset, moment_dtype):
    """Both trainers take the same two steps (det=True: no draw) from the
    same start, the port's from the converted params; the port's
    checkpoint payload through ``train_state_to_flax`` against JAX's
    TrainState: params, count and step exactly as counted, mu and nu per
    leaf. f32 moments at 1e-4 of each leaf's largest entry plus 1e-5; bf16
    moments at 2^-7 of it (one bf16 rounding of values that agree to f32
    rounding may move a stored moment by a relative 2^-8, and the second
    step's blend carries the first step's rounding)."""
    model_cfg = jcfg.ModelConfig(n_cgs=3, n_basis=16, n_rbf=3, enc_nconv=1, dec_nconv=1,
                                 dec_type="pseudo", det=True, compute_dtype="float32")
    cfg = jcfg.ExperimentConfig(model=model_cfg, data=jcfg.DataConfig(batch_size=BATCH, seed=0),
                                train=jcfg.TrainConfig(lr=1e-3, beta=0.05, gamma=1.0,
                                                       adam_moment_dtype=moment_dtype))
    jtr = JaxTrainer(jcgvae.build_flagship_model(model_cfg), cfg)
    jstate = jtr.init_state(small_dataset.batch(np.arange(BATCH)), seed=0)
    tc = tcfg.ExperimentConfig.from_json(cfg.to_json())
    model = build_flagship_model(tc.model)
    model.load_state_dict(convert.convert_flax_params(jax.device_get(jstate.params), tc.model))
    tr = Trainer(model, tc, device="cpu")
    tds = CGDatasetArrays(**{f.name: getattr(small_dataset, f.name)
                             for f in dataclasses.fields(CGDatasetArrays)})
    state = tr.init_state(tds.batch(np.arange(BATCH)))
    for i in range(2):
        idx = np.arange(BATCH) + BATCH * i
        jstate, _ = jtr.train_step(jstate, small_dataset.batch(idx), jax.random.PRNGKey(i))
        state, _ = tr.train_step(state, tds.batch(idx))
    got = convert.train_state_to_flax(_payload(state), tc)
    want = serialization.to_state_dict(jax.device_get(jstate))
    assert set(got) == set(want) == {"params", "opt_state", "step", "lr"}
    assert got["step"].dtype == np.int32 and int(got["step"]) == int(want["step"]) == 2
    adam, jadam = got["opt_state"]["1"], want["opt_state"]["1"]
    assert got["opt_state"]["0"] == want["opt_state"]["0"] == {}
    assert int(adam["count"]) == int(jadam["count"]) == 2
    assert np.float32(got["lr"]) == np.float32(want["lr"])
    rel = 1e-4 if moment_dtype == "float32" else 2.0 ** -7
    for part in ("mu", "nu"):
        g_leaves = jax.tree_util.tree_leaves_with_path(_plain(adam[part]))
        w_leaves = dict(jax.tree_util.tree_leaves_with_path(_plain(jadam[part])))
        assert len(g_leaves) == len(w_leaves)
        for path, g in g_leaves:
            assert str(w_leaves[path].dtype) == moment_dtype, path
            assert (g.dtype == torch.bfloat16 if moment_dtype == "bfloat16"
                    else g.dtype == np.float32), path
            w = np.asarray(w_leaves[path], np.float32)
            g = g.float().numpy() if isinstance(g, torch.Tensor) else g
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 + rel * np.abs(w).max(),
                                       err_msg=f"{part} {path}")
    for path, g in jax.tree_util.tree_leaves_with_path(got["params"]):
        w = dict(jax.tree_util.tree_leaves_with_path(want["params"]))[path]
        np.testing.assert_allclose(g, w, rtol=0, atol=2e-5 + 1e-4 * np.abs(w).max())
    # and back: the payload returns bit for bit
    back = convert.train_state_from_flax(got, tc)
    payload = _payload(state)
    assert list(back["params"]) == list(payload["params"])
    for k in payload["params"]:
        assert torch.equal(back["params"][k], payload["params"][k])
    for k in ("count", "mu", "nu"):
        assert back["opt_state"][k].dtype == payload["opt_state"][k].dtype
        assert torch.equal(back["opt_state"][k], payload["opt_state"][k])
    assert back["step"].dtype == torch.int64 and torch.equal(back["step"], payload["step"])
    assert torch.equal(back["lr"], payload["lr"])


# ------------------------------------------------------- PCN and DiffPool runs
PCN_FLAGS = ["-ndata", "8", "-n_basis", "16", "-n_rbf", "5", "-dec_nconv", "1", "-nepochs", "1",
             "-batch_size", "2", "-n_dump", "1", "-min_res", "6", "-max_res", "10"]


def test_run_pcn_params_load_into_jax(tmp_path, proteins):
    """The port's run_pcn writes params.msgpack: flax's from_bytes with
    JAX's template loads it, and JAX's PCN on it gives the port's forward
    on the same file (f32, rtol 1e-4 / atol 1e-5); the legacy params.pt
    still reads."""
    run_pcn.main(PCN_FLAGS + ["-logdir", str(tmp_path / "pcn"), "--device", "cpu"])
    (run,) = tmp_path.glob("pcn_*")
    assert not (run / "params.pt").exists()
    a = run_pcn.build_parser().parse_args(PCN_FLAGS)
    tc = run_pcn.model_config(a)
    cfg = jcfg.ModelConfig(**dataclasses.asdict(tc))
    items, _ = proteins
    jds = jsc.build_pcn_dataset(items, cg_cutoff=a.cutoff)
    tds = sidechain.build_pcn_dataset(items, cg_cutoff=a.cutoff)
    idx = np.arange(2)
    cam = jds.ca_mask_for(idx)
    jm = jcgvae.PCN(cfg=cfg)
    template = jm.init({"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
                       jds.batch(idx), jnp.asarray(cam))["params"]
    data = (run / "params.msgpack").read_bytes()
    params = serialization.from_bytes(template, data)
    assert flax_msgpack.dumps(flax_msgpack.loads(data)) == data
    ref = jm.apply({"params": params}, jds.batch(idx), jnp.asarray(cam))
    sd = convert.load_params(str(run / "params.msgpack"), tc)
    tm = PCN(tc)
    tm.load_state_dict(sd)
    with torch.no_grad():
        out = tm(tds.batch(idx), torch.as_tensor(cam))
    np.testing.assert_allclose(out.xyz_recon.numpy(), np.asarray(ref.xyz_recon), **F32_TOL)
    # a params.pt that earlier versions of the port wrote
    torch.save(sd, tmp_path / "params.pt")
    legacy = convert.load_params(str(tmp_path / "params.pt"), tc)
    assert all(torch.equal(legacy[k], sd[k]) for k in sd)


DP_ARGS = ["-n_cgs", "4", "-num_features", "8", "-n_rbf", "3", "-enc_nconv", "1",
           "-dec_nconv", "1", "-ndata", "16", "-nepochs", "1", "-batch_size", "4",
           "-nsplits", "2"]


def test_run_diffpool_params_load_into_jax(tmp_path, monkeypatch, dipeptide):
    """The port's run_diffpool writes params.msgpack per fold: flax's
    from_bytes with JAX's template loads it, and JAX's DiffPoolVAE on it
    gives the port's forward with the same draws (f32, rtol 1e-4 / atol
    1e-5)."""
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=16, seed=0)
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    run_diffpool.main(DP_ARGS + ["-logdir", str(tmp_path / "dp"), "--device", "cpu"])
    (run,) = tmp_path.glob("dp_*")
    path = run / "fold0" / "params.msgpack"
    assert path.is_file() and not (run / "fold0" / "params.pt").exists()
    a = run_diffpool.build_parser().parse_args(DP_ARGS)
    tc = run_diffpool.config_from_args(a, z.shape[0])
    cfg = jcfg.DiffPoolConfig(**dataclasses.asdict(tc))
    jb = jdiffpool_data(frames[:2], z, bonds).batch(np.arange(2))
    jargs = (jnp.asarray(jb.z), jnp.asarray(jb.xyz), jnp.asarray(jb.adj), jnp.asarray(0.7))
    jm = jdp.DiffPoolVAE(cfg=cfg)
    template = jm.init({"params": jax.random.PRNGKey(0), "gumbel": jax.random.PRNGKey(1),
                        "sample": jax.random.PRNGKey(2)}, *jargs)["params"]
    params = serialization.from_bytes(template, path.read_bytes())
    tm = DiffPoolVAE(tc)
    tm.load_state_dict(convert.load_params(str(path), tc))
    rng = np.random.default_rng(0)
    u = rng.uniform(1e-3, 1.0, size=tm.pooler.noise_shape(2, z.shape[0])).astype(np.float32)
    eps = rng.normal(size=(2, tc.n_cgs, tc.feat_dim)).astype(np.float32)
    monkeypatch.setattr(jax.random, "uniform",
                        lambda key, shape, dtype=jnp.float32, minval=0.0, maxval=1.0:
                        jnp.asarray(u, dtype).reshape(shape))
    monkeypatch.setattr(jax.random, "normal", lambda key, shape, dtype=jnp.float32:
                        jnp.asarray(eps, dtype).reshape(shape))
    ref = jm.apply({"params": params}, *jargs,
                   rngs={"gumbel": jax.random.PRNGKey(3), "sample": jax.random.PRNGKey(4)})
    with torch.no_grad():
        out = tm(torch.as_tensor(np.asarray(jb.z)).long(), torch.as_tensor(np.asarray(jb.xyz)),
                 torch.as_tensor(np.asarray(jb.adj)), 0.7, u=torch.as_tensor(u),
                 eps=torch.as_tensor(eps))
    np.testing.assert_allclose(out.xyz_recon.numpy(), np.asarray(ref.xyz_recon), **F32_TOL)


# -------------------------------------------------------------------- orbax
def test_an_orbax_directory_names_the_converter(tmp_path):
    """A step that orbax wrote (its _CHECKPOINT_METADATA and default/) is
    never read past: read, latest_step and so resume raise, naming the
    converter script."""
    step = tmp_path / "fold0" / "ckpt" / "12"
    (step / "default").mkdir(parents=True)
    (step / "_CHECKPOINT_METADATA").write_text(json.dumps({"item_handlers": {}}))
    mgr = CheckpointManager(str(tmp_path / "fold0" / "ckpt"))
    for call in (mgr.read, mgr.latest_step, mgr.all_steps):
        with pytest.raises(OrbaxCheckpointError, match="scripts/convert_run.py --to torch"):
            call()
