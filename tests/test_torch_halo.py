"""The atom-sharded halo stack in the PyTorch port (``parallel.halo``)
against the JAX package's (``coarsegrainingvae_tpu.parallel.halo``): the
cases of tests/test_halo.py.

``plan_halo``'s arrays are compared bit for bit. The sharded passes run on
gloo ranks in spawned processes (one world per size for the module,
``tests/torch_parallel_ranks.py::halo_cases``), each rank on its block of
the plan's sharded order, from the JAX parameters converted by
``convert_equistack_params`` (a single block's by name); the reference is
the JAX package's unsharded block or ``EquiStack``, forward and gradient,
at f32 within 2e-5 (tests/test_halo.py's tolerance for one message pass),
its absolute part scaled to each tensor's largest entry.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from coarsegrainingvae_tpu.data.neighbors import make_directed, radius_graph_dense
from coarsegrainingvae_tpu.models.conv import EquiMessageBlock
from coarsegrainingvae_tpu.parallel import halo as jhalo
from coarsegrainingvae_tpu_torch.convert import convert_equistack_params
from coarsegrainingvae_tpu_torch.parallel import halo
from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

torch.set_num_threads(1)

TOL = dict(rtol=2e-5, atol=2e-5)
WORLDS = (2, 4)


def _cloud(n, cutoff, seed, density=0.05):
    """tests/test_halo.py's box: elongated along x, receiver-sorted edges."""
    rng = np.random.default_rng(seed)
    side = (n / density) ** (1 / 3)
    xyz = rng.uniform(0, 1, (n, 3)) * np.array([3 * side, side, side])
    edges = make_directed(radius_graph_dense(xyz, cutoff))
    return xyz.astype(np.float32), edges[np.argsort(edges[:, 0], kind="stable")]


def _features(n, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f)).astype(np.float32),
            rng.normal(size=(n, 3, f)).astype(np.float32))


def _case(n, cutoff, feat_dim, seed, stack):
    """One case: inputs, the JAX reference (outputs, parameter gradients by
    the port's names, input gradient) and the converted parameters."""
    xyz, edges = _cloud(n, cutoff, seed)
    s, v = _features(n, feat_dim, seed + 1)
    kw = dict(n_conv=2, feat_dim=feat_dim, n_rbf=6, activation="swish", cutoff=cutoff)
    if stack:
        module = jhalo.EquiStack(**kw)
        args = (jnp.asarray(xyz), jnp.asarray(edges), None)
        params = module.init(jax.random.PRNGKey(0), s, v, *args)["params"]

        def apply(p, s_in):
            return module.apply({"params": p}, s_in, jnp.asarray(v), *args)
    else:
        module = EquiMessageBlock(feat_dim=feat_dim, activation="swish", n_rbf=6,
                                  cutoff=cutoff, edges_sorted=True)
        r_ij = jnp.asarray(xyz[edges[:, 1]] - xyz[edges[:, 0]])
        params = module.init(jax.random.PRNGKey(0), s, v, r_ij, jnp.asarray(edges),
                             None)["params"]

        def apply(p, s_in):
            return module.apply({"params": p}, s_in, jnp.asarray(v), r_ij,
                                jnp.asarray(edges), None)

    def loss(p, s_in):
        so, vo = apply(p, s_in)
        return jnp.sum(so ** 2) + jnp.sum(vo ** 2), (so, vo)

    (_, (so, vo)), (g_p, g_s) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(s))

    def port_names(tree):
        if stack:
            return convert_equistack_params(jax.device_get(tree), 2)
        # one block: the stack's converter on a one-layer tree, msgs.0.* -> *
        one = convert_equistack_params({"EquiMessageBlock_0": jax.device_get(tree),
                                        "UpdateBlock_0": _dummy_update(feat_dim)}, 1)
        return {k[len("msgs.0."):]: t for k, t in one.items() if k.startswith("msgs.0.")}

    return dict(xyz=xyz, edges=edges, s=s, v=v, kw=kw, stack=stack,
                state_dict={k: t.numpy() for k, t in port_names(params).items()},
                ref=dict(s=np.asarray(so), v=np.asarray(vo), g_s=np.asarray(g_s),
                         grads={k: t.numpy() for k, t in port_names(g_p).items()}))


def _dummy_update(f):
    """An UpdateBlock tree of zeros (each modules.Dense wraps one nn.Dense)."""
    z = np.zeros
    return {"Dense_0": {"Dense_0": {"kernel": z((f, f))}},
            "Dense_1": {"Dense_0": {"kernel": z((f, f))}},
            "Dense_2": {"Dense_0": {"kernel": z((2 * f, f)), "bias": z(f)}},
            "Dense_3": {"Dense_0": {"kernel": z((f, 3 * f)), "bias": z(3 * f)}}}


CASES = {
    "message": dict(n=256, cutoff=3.0, feat_dim=16, seed=0, stack=False),
    "message_grad": dict(n=256, cutoff=3.0, feat_dim=8, seed=5, stack=False),
    "stack": dict(n=512, cutoff=2.5, feat_dim=8, seed=11, stack=True),
    "stack_grad": dict(n=256, cutoff=3.0, feat_dim=8, seed=13, stack=True),
    # 502 atoms: 2 ghosts at world 4, none at world 2
    "uneven": dict(n=502, cutoff=2.5, feat_dim=8, seed=21, stack=True),
}


@pytest.fixture(scope="module")
def cases():
    return {name: _case(**kw) for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def worlds(cases, tmp_path_factory):
    out = {}
    for world in WORLDS:
        run = {}
        for name, c in cases.items():
            h = halo.min_halo(c["xyz"], c["edges"], world)
            run[name] = {k: c[k] for k in ("xyz", "edges", "s", "v", "kw", "stack",
                                           "state_dict")} | {"halo": h}
        store = tmp_path_factory.mktemp(f"halo{world}") / "store"
        out[world] = spawn_ranks(ranks.halo_cases, world, str(store), (run,))
    return out


def _close(got, want, what):
    """Within TOL of each element, the absolute part scaled to the tensor's
    largest entry: a sum that cancels to near zero keeps the rounding of its
    large addends (f32 in XLA's order and in torch's)."""
    np.testing.assert_allclose(got, want, rtol=TOL["rtol"],
                               atol=TOL["atol"] * max(1.0, np.abs(want).max()), err_msg=what)


def _gathered(results, name, key, plan):
    return np.concatenate([r[name][key] for r in results])[plan.inv_order]


@pytest.mark.parametrize("n,n_shards,cutoff,halo_w,seed", [
    (256, 4, 3.0, 32, 0),
    (512, 8, 2.5, 32, 3),
    (500, 8, 2.5, 24, 21),       # uneven: 4 ghost atoms, shard 63
    (512, 4, 2.5, 64, 11),
])
def test_plan_halo_arrays_equal_jax(n, n_shards, cutoff, halo_w, seed):
    xyz, edges = _cloud(n, cutoff, seed)
    got = halo.plan_halo(xyz, edges, n_shards, halo_w)
    want = jhalo.plan_halo(xyz, edges, n_shards, halo_w)
    for k in ("n_shards", "shard_size", "halo", "n_atoms"):
        assert getattr(got, k) == getattr(want, k), k
    for k in ("order", "inv_order", "edges", "edge_mask"):
        a, b = getattr(got, k), getattr(want, k)
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)
    np.testing.assert_array_equal(got.pad(xyz), want.pad(xyz))
    # the padding stays receiver-sorted, so the CSR segment sums take it
    for d in range(n_shards):
        assert np.all(np.diff(got.edges[d, :, 0]) >= 0)


def test_plan_halo_rejects_an_undersized_halo():
    xyz, edges = _cloud(256, cutoff=3.0, seed=1)
    for fn in (halo.plan_halo, jhalo.plan_halo):
        with pytest.raises(ValueError, match="halo"):
            fn(xyz, edges, n_shards=4, halo=1)
    h = halo.min_halo(xyz, edges, 4)
    halo.plan_halo(xyz, edges, 4, h)
    with pytest.raises(ValueError, match="halo"):
        halo.plan_halo(xyz, edges, 4, h - 1)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("name", list(CASES))
def test_sharded_pass_matches_jax(cases, worlds, world, name):
    """Forward, parameter gradients and the input gradient of the sharded
    message pass or stack against JAX's unsharded one."""
    c = cases[name]
    plan = halo.plan_halo(c["xyz"], c["edges"], world,
                          halo.min_halo(c["xyz"], c["edges"], world))
    res = worlds[world]
    if name == "message":
        # the exchange is exercised: some senders sit in a halo
        senders = plan.edges[..., 1][plan.edge_mask]
        assert ((senders < plan.halo) | (senders >= plan.halo + plan.shard_size)).any()
    if name == "uneven" and world == 4:
        assert plan.n_padded == 504
    for key in ("s", "v", "g_s"):
        _close(_gathered(res, name, key, plan), c["ref"][key], key)
    for r in res:
        for k, want in c["ref"]["grads"].items():
            _close(r[name]["grads"][k], want, k)


def test_equistack_converts_from_jax():
    """convert_equistack_params maps every leaf of JAX's EquiStack; the
    port's EquiStack then gives JAX's outputs on one rank."""
    c = _case(n=128, cutoff=3.0, feat_dim=8, seed=2, stack=True)
    stack = halo.EquiStack(**c["kw"])
    stack.load_state_dict({k: torch.as_tensor(v) for k, v in c["state_dict"].items()})
    so, vo = stack(*(torch.as_tensor(a) for a in (c["s"], c["v"], c["xyz"])),
                   torch.as_tensor(c["edges"], dtype=torch.long))
    _close(so.detach().numpy(), c["ref"]["s"], "s")
    _close(vo.detach().numpy(), c["ref"]["v"], "v")
