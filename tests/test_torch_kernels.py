"""The port's two kernel modules against the JAX Pallas kernels.

On the CPU the port's wrappers take the kernels' plain versions
(message_reference, pseudo_reference) and their plain VJPs
(message_vjp_reference, pseudo_vjp_reference); those are held against the
JAX kernels run in interpret mode, forward and backward (jax.vjp runs the
Pallas _bwd_kernel), against the JAX references, against torch autograd of
the plain forward, and by gradcheck in float64. The CUDA kernels themselves
are compared with the plain versions on the card by tests/test_torch_gpu.py
and by chip_smoke.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.ops import pallas_message, pallas_pseudo
from coarsegrainingvae_tpu_torch.ops import read_launches
from coarsegrainingvae_tpu_torch.ops.fused_message import (
    fused_message,
    message_reference,
    message_vjp_reference,
)
from coarsegrainingvae_tpu_torch.ops.fused_pseudo import (
    fused_pseudo_message,
    fused_pseudo_vjp,
    pseudo_reference,
    pseudo_vjp_reference,
)

torch.set_num_threads(1)

B, F, R, CUT = 3, 24, 6, 9.0
TOL = dict(rtol=1e-4, atol=1e-5)
# gradients: the tolerance of the JAX package's own VJP tests
# (tests/test_pallas_pseudo.py:100)
GRAD_TOL = dict(rtol=2e-4, atol=2e-5)


def _message_inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    xyz = (rng.normal(size=(B, n, 3)) * 3.0).astype(np.float32)
    mask = np.ones((B, n), np.float32)
    mask[:, -1] = 0.0                               # a masked last row
    phi = rng.normal(size=(B, n, s, F)).astype(np.float32)
    v = rng.normal(size=(B, n, 3, F)).astype(np.float32)
    w = (rng.normal(size=(R + 1, s, F)) * 0.3).astype(np.float32)
    return xyz, mask, phi, v, w


def _pseudo_inputs(m, seed):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = np.ones((B, m), np.float32)
    mask[:, -1] = 0.0
    return (arr(B, m, 3, scale=3.0), mask, arr(B, m, 9, F), arr(B, m, F),
            arr(B, m, F), arr(B, m, 3, F), arr(B, m, 3, F), arr(R + 1, 9, F, scale=0.3))


def _close(port_out, jax_out):
    for a, b in zip(port_out, jax_out):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


# N = 11 is not a multiple of the TPU kernel's 8-row tile; N = 3 is the
# dipeptide bead graph the prior runs on
@pytest.mark.parametrize("n", [3, 11])
@pytest.mark.parametrize("s", [3, 4])
def test_message_plain_matches_jax_kernel(n, s):
    args = _message_inputs(n, s, seed=n * 10 + s)
    jax_args = [jnp.asarray(a) for a in args]
    interp = jax.jit(functools.partial(pallas_message.fused_message, cutoff=CUT,
                                       n_rbf=R, tile_i=8, interpret=True))
    ref_kernel = interp(*jax_args)
    ref_plain = pallas_message.message_reference(*jax_args, CUT, R)
    out = fused_message(*[torch.as_tensor(a) for a in args], CUT, R)
    _close(out, ref_kernel)
    _close(out, ref_plain)
    # the masked receiver gets nothing, and nothing flows from it
    assert float(out[0][:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("m", [3, 6])
def test_pseudo_plain_matches_jax_kernel(m):
    args = _pseudo_inputs(m, seed=m)
    jax_args = [jnp.asarray(a) for a in args]
    interp = jax.jit(functools.partial(pallas_pseudo.fused_pseudo_message,
                                       cutoff=CUT, n_rbf=R, tile_b=8,
                                       interpret=True))
    ref_kernel = interp(*jax_args)
    ref_plain = pallas_pseudo.pseudo_reference(*jax_args, CUT, R)
    out = fused_pseudo_message(*[torch.as_tensor(a) for a in args], CUT, R)
    _close(out, ref_kernel)
    _close(out, ref_plain)


def test_cpu_tensors_take_the_plain_version_and_are_not_counted():
    margs = [torch.as_tensor(a) for a in _message_inputs(5, 3, seed=1)]
    pargs = [torch.as_tensor(a) for a in _pseudo_inputs(3, seed=1)]
    before = read_launches()
    for got, want in zip(fused_message(*margs, CUT, R), message_reference(*margs, CUT, R)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    for got, want in zip(fused_pseudo_message(*pargs, CUT, R),
                         pseudo_reference(*pargs, CUT, R)):
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert read_launches() == before


def test_wrappers_refuse_autograd_and_other_devices():
    """The wrappers no longer refuse autograd: it goes through them (their
    backward is the plain VJP on the CPU), and xyz and mask get no
    gradient. They still refuse any device but the CPU and CUDA."""
    margs = [torch.as_tensor(a) for a in _message_inputs(4, 3, seed=2)]
    margs[0].requires_grad_(True)
    margs[2].requires_grad_(True)
    before = read_launches()
    ds, dv = fused_message(*margs, CUT, R)
    assert ds.requires_grad and dv.requires_grad
    (ds.sum() + dv.sum()).backward()
    assert margs[0].grad is None and margs[2].grad is not None
    assert read_launches() == before
    with torch.no_grad():
        assert not fused_message(*margs, CUT, R)[0].requires_grad
    pargs = [torch.as_tensor(a).to("meta") for a in _pseudo_inputs(3, seed=2)]
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_pseudo_message(*pargs, CUT, R)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_message(*[a.to("meta") for a in margs], CUT, R)


def _cotangents(outs, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=tuple(o.shape)).astype(np.float32) for o in outs]


@pytest.mark.parametrize("n", [3, 11])
@pytest.mark.parametrize("s", [3, 4])
def test_message_vjp_matches_jax_kernel(n, s):
    """The plain VJP against jax.vjp of the Pallas kernel in interpret mode
    (its hand-derived _bwd_kernel) and against torch autograd of the plain
    forward; random xyz, so a sign error on the antisymmetric unit channel
    shows."""
    args = _message_inputs(n, s, seed=n * 10 + s + 1)
    gs, gv = _cotangents(message_reference(*[torch.as_tensor(a) for a in args], CUT, R), seed=n + s)
    xyz, mask = jnp.asarray(args[0]), jnp.asarray(args[1])
    kern = functools.partial(pallas_message.fused_message, cutoff=CUT, n_rbf=R,
                             tile_i=8, interpret=True)
    _, vjp = jax.vjp(lambda *a: kern(xyz, mask, *a), *[jnp.asarray(a) for a in args[2:]])
    ref = jax.jit(vjp)((jnp.asarray(gs), jnp.asarray(gv)))
    t = [torch.as_tensor(a) for a in args]
    out = message_vjp_reference(*t, torch.as_tensor(gs), torch.as_tensor(gv), CUT, R)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    leaves = [x.clone().requires_grad_(True) for x in t[2:]]
    auto = torch.autograd.grad(message_reference(*t[:2], *leaves, CUT, R), leaves,
                               [torch.as_tensor(gs), torch.as_tensor(gv)])
    for a, b in zip(out, auto):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    # the masked last node gets no gradient
    assert float(out[0][:, -1].abs().max()) == 0.0 and float(out[1][:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("m", [3, 6])
def test_pseudo_vjp_matches_jax_kernel(m):
    args = _pseudo_inputs(m, seed=m + 20)
    t = [torch.as_tensor(a) for a in args]
    cts = _cotangents(pseudo_reference(*t, CUT, R), seed=m + 21)
    xyz, mask = jnp.asarray(args[0]), jnp.asarray(args[1])
    kern = functools.partial(pallas_pseudo.fused_pseudo_message, cutoff=CUT,
                             n_rbf=R, tile_b=8, interpret=True)
    _, vjp = jax.vjp(lambda *a: kern(xyz, mask, *a), *[jnp.asarray(a) for a in args[2:]])
    ref = jax.jit(vjp)(tuple(jnp.asarray(c) for c in cts))
    tcts = [torch.as_tensor(c) for c in cts]
    out = pseudo_vjp_reference(*t, *tcts, CUT, R)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **GRAD_TOL)
    leaves = [x.clone().requires_grad_(True) for x in t[2:]]
    auto = torch.autograd.grad(pseudo_reference(*t[:2], *leaves, CUT, R), leaves, tcts)
    for a, b in zip(out, auto):
        torch.testing.assert_close(a, b, **GRAD_TOL)
    for grad in out[:5]:
        assert float(grad[:, -1].abs().max()) == 0.0


def test_wrapper_backward_passes_gradcheck_in_float64():
    """The autograd Functions' hand-derived backward (the plain VJPs on the
    CPU) against finite differences of their forward, in float64."""
    def f64(a):
        return torch.as_tensor(a, dtype=torch.float64)

    margs = [f64(a) for a in _message_inputs(5, 4, seed=30)]
    margs = [a[..., :6] if i in (2, 3, 4) else a for i, a in enumerate(margs)]
    for a in margs[2:]:
        a.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda *a: fused_message(*margs[:2], *a, CUT, R),
                                    margs[2:])
    pargs = [f64(a) for a in _pseudo_inputs(3, seed=31)]
    pargs = [a if i < 2 else a[..., :4] for i, a in enumerate(pargs)]
    for a in pargs[2:]:
        a.requires_grad_(True)
    assert torch.autograd.gradcheck(lambda *a: fused_pseudo_message(*pargs[:2], *a, CUT, R),
                                    pargs[2:])


# the message cases keep the ids they had before the pseudo cases joined
@pytest.mark.parametrize("wrapper,n_rbf", [
    pytest.param("message", 0, id="0"), pytest.param("message", 16, id="16"),
    pytest.param("pseudo", 0, id="pseudo-0"), pytest.param("pseudo", 16, id="pseudo-16")])
def test_message_wrapper_refuses_basis_sizes_without_a_kernel(wrapper, n_rbf):
    """The CUDA kernels, message and pseudo, exist for R+1 in 2..16 (a
    template parameter) and for every R+1 past 16 (the wide kernels, whose
    basis comes in chunks and which keep nothing per basis function in
    shared memory). So each wrapper's input check refuses only n_rbf 0, and
    takes n_rbf 16 and the wide sizes that some earlier design refused (95,
    201) or no test reached (512), before a build or a launch. The check
    runs on CPU tensors here as it does on CUDA ones."""
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    if wrapper == "message":
        check, s = mo._check_cuda_inputs, 3
        xyz, mask, phi, v, _ = [torch.as_tensor(a) for a in _message_inputs(4, 3, seed=3)]
        args = {"xyz": xyz, "mask": mask, "phi": phi, "v": v}
        want = (B, 4, 3, F)
    else:
        check, s = po._check_cuda_inputs, 9
        names = ("xyz", "mask", "phi", "s", "sbar", "v", "vbar")
        args = dict(zip(names, [torch.as_tensor(a) for a in _pseudo_inputs(4, seed=3)[:7]]))
        want = (B, 4, F)
    if n_rbf == 0:
        args["w"] = torch.zeros(1, s, F)
        with pytest.raises(ValueError, match="n_rbf"):
            check(args, 0)
    for taken in (R, 95, 201, 512) if n_rbf == 0 else (n_rbf,):
        args["w"] = torch.zeros(taken + 1, s, F)
        assert check(args, taken) == want
    # a weight tensor of another basis size is refused
    args["w"] = torch.zeros(R + 2, s, F)
    with pytest.raises(ValueError, match="w has shape"):
        check(args, R)
