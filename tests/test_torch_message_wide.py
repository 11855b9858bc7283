"""The message kernels' wide path (R+1 > 16, csrc/fused_message.cu): its
numerics on the CPU, against the plain basis and the JAX package.

The wide kernels cut the basis K = adj env [rbf_1..R, 1] into the fewest
chunks of at most kWideChunk functions, all of one width (the last
zero-padded). pair_geometry.cuh::chunk_record builds each chunk from an
accurate sin and cos (sincospif) at the chunk's first angle and at the step
pi d / cutoff, then the angle-addition recurrence within the chunk; each
chunk adds its share of the message, and of its VJP, to sums that stay in
registers across the chunks, and writes its own rows of d_w.

(a) builds that basis in torch f32 in chunk_record's order of operations
and holds it against ops/geometry.py::pair_filter_basis in float64.
(b) takes each chunk's share through the port's plain versions (the chunk's
basis in place of the whole one), sums the shares, and holds the sum
against the JAX package's message_reference and jax.vjp of it in float64,
and in f32 against the Pallas kernel in interpret mode. The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import functools
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.ops import pallas_message
from coarsegrainingvae_tpu_torch.ops import fused_message as mo
from coarsegrainingvae_tpu_torch.ops.geometry import EPS, pair_filter_basis
from test_torch_kernels import CUT, _cotangents, _message_inputs

torch.set_num_threads(1)

HEADER = Path(__file__).resolve().parents[1] / "coarsegrainingvae_tpu_torch/csrc/pair_geometry.cuh"
CHUNK = int(re.search(r"constexpr int kWideChunk = (\d+);", HEADER.read_text()).group(1))
EXACT_FROM = int(re.search(r"constexpr int kExactFrom = (\d+);", HEADER.read_text()).group(1))
# the kernels' gate against the plain version: max |a - b| <= 1e-4 max |b|
# (chip_smoke.KERNEL_RTOL); in float64 only the order of the sums differs
RTOL32, TOL64 = 1e-4, dict(rtol=1e-9, atol=1e-9)


def chunk_width(r_aug):
    """fused_message.cu::with_wide: the fewest chunks of at most CHUNK
    functions, all of one width."""
    n = -(-r_aug // CHUNK)
    return -(-r_aug // n)


def _sincospi(x):
    """sin and cos of pi x, correctly rounded to x's dtype (sincospif is
    within 1 ulp)."""
    a = math.pi * x.double()
    return torch.sin(a).to(x.dtype), torch.cos(a).to(x.dtype)


def chunk_values(d2, adj, r_aug, r0, width, cutoff):
    """One chunk of pair_geometry.cuh::chunk_record's K, (..., width), zero
    past R+1, from the squared distance (plus the epsilon) and the
    adjacency, in d2's dtype: the angle-addition recurrence from an accurate
    sin and cos at the chunk's first angle, or, for a basis of more than
    EXACT_FROM functions, each function as ops/basis.py::painn_radial_basis
    rounds it (the correctly rounded distance, coefficient, angle and
    quotient)."""
    dtype = d2.dtype
    inv_d = torch.rsqrt(d2)
    d = d2 * inv_d
    u = d * (1.0 / torch.tensor(cutoff, dtype=dtype))
    s1, c1 = _sincospi(u)
    ae = adj * (0.5 * (c1 + 1.0))
    zero = torch.zeros_like(ae)
    k = []
    if r_aug > EXACT_FROM:
        dp = torch.sqrt(d2)
        for j in range(r0, r0 + width):
            coef = (torch.tensor(j + 1, dtype=dtype) * torch.tensor(math.pi, dtype=dtype)
                    / torch.tensor(cutoff, dtype=dtype))
            k.append(ae * (torch.sin(coef * dp) / dp) if j < r_aug - 1
                     else (ae if j == r_aug - 1 else zero))
    else:
        sk, ck = _sincospi((r0 + 1) * u)
        for j in range(r0, r0 + width):
            k.append(ae * inv_d * sk if j < r_aug - 1 else (ae if j == r_aug - 1 else zero))
            sk, ck = sk * c1 + ck * s1, ck * c1 - sk * s1
    return torch.stack(k, -1)


def chunk_bases(xyz, mask, cutoff, n_rbf, width=None):
    """pair_geometry.cuh::chunk_record for every chunk (of ``width``
    functions, the message kernels' width by default), in xyz's dtype:
    (unit (B,N,N,3), adj (B,N,N), [K (B,N,N,R+1), zero outside the chunk,
    per chunk])."""
    r_aug, n = n_rbf + 1, xyz.shape[1]
    width = width or chunk_width(r_aug)
    r = xyz[:, None, :, :] - xyz[:, :, None, :]          # x_q - x_p
    d2 = (r * r).sum(-1) + EPS
    inv_d = torch.rsqrt(d2)
    d = d2 * inv_d
    unit = r * inv_d[..., None]
    m = mask.to(xyz.dtype)
    adj = ((d < cutoff) & ~torch.eye(n, dtype=torch.bool)) * m[:, :, None] * m[:, None, :]
    chunks = []
    for r0 in range(0, r_aug, width):
        k = torch.zeros(d.shape + (r_aug,), dtype=xyz.dtype)
        top = min(r0 + width, r_aug)
        k[..., r0:top] = chunk_values(d2, adj, r_aug, r0, width, cutoff)[..., :top - r0]
        chunks.append(k)
    return unit, adj, chunks


# the widest basis the tests hold the wide kernels to (the wrappers take any)
WIDEST = 512


def test_chunks_cover_the_basis_once():
    """Every wide basis (R+1 from 17 to WIDEST + 1) splits into chunks of
    9 to CHUNK functions (the kernels' instantiations), padding fewer than
    one chunk's worth."""
    for r_aug in range(17, WIDEST + 2):
        width, n = chunk_width(r_aug), -(-r_aug // CHUNK)
        assert 9 <= width <= CHUNK and n * width - r_aug < n and (n - 1) * width < r_aug


# The largest error found, per basis function relative to its max |K|, on
# the random frames: <= 1.7e-6 up to n_rbf 31 (the recurrence of at most
# CHUNK - 1 steps adds ~3e-7 whatever R is); past R+1 = EXACT_FROM every
# function rounds as the plain version does, so from n_rbf 32 on the largest
# errors (5.35e-6 at 63, 1.26e-5 at 200, 4.77e-5 at 512) are the plain f32
# basis's own (the f32 distance through an angle of up to 512 pi sets
# them), a margin of 2.1x under the 1e-4 gate at 512; on the line of
# distances <= 2.3e-6.
@pytest.mark.parametrize("n_rbf", [16, 20, 31, 32, 63, 200, WIDEST])
def test_chunked_basis_matches_the_plain_basis_in_float64(n_rbf):
    """The chunked f32 basis, over 4,000 distances spanning (0, cutoff) and
    over the pairs of random frames, within 1e-4 of each basis function's
    max |K| of the plain basis in float64 on the same f32 positions."""
    d = np.linspace(0.05, CUT - 1e-3, 4000)
    line = np.zeros((d.size, 2, 3), np.float32)
    line[:, 1, 0] = d
    frames = (np.random.default_rng(n_rbf).normal(size=(8, 11, 3)) * 3.0).astype(np.float32)
    for xyz in (torch.as_tensor(line), torch.as_tensor(frames)):
        mask = torch.ones(xyz.shape[:2])
        got = sum(chunk_bases(xyz, mask, CUT, n_rbf)[2]).double()
        want = pair_filter_basis(xyz.double(), mask.double(), CUT, n_rbf)[2]
        scale = want.abs().amax(dim=(0, 1, 2))
        assert bool((scale > 0).all())
        err = ((got - want).abs().amax(dim=(0, 1, 2)) / scale).max().item()
        assert err <= RTOL32, err


def _inputs(n, s, n_rbf, seed):
    """test_torch_kernels' inputs with a wide basis's weights."""
    xyz, mask, phi, v, _ = _message_inputs(n, s, seed)
    w = (np.random.default_rng(seed + 1).normal(size=(n_rbf + 1, s, phi.shape[-1]))
         * 0.3).astype(np.float32)
    return xyz, mask, phi, v, w


def chunked(fn, args, n_rbf, monkeypatch):
    """fn (the port's message_reference or message_vjp_reference) chunk by
    chunk: each chunk's basis in place of the whole one, the shares
    summed."""
    unit, adj, chunks = chunk_bases(args[0], args[1], CUT, n_rbf)
    total = None
    for k in chunks:
        monkeypatch.setattr(mo, "pair_filter_basis", lambda *a, k=k: (unit, adj, k))
        share = fn(*args, CUT, n_rbf)
        total = share if total is None else [a + b for a, b in zip(total, share)]
    monkeypatch.undo()
    return total


def _jax_vjp(fn, args, cts):
    xyz, mask = jnp.asarray(args[0]), jnp.asarray(args[1])
    _, vjp = jax.vjp(lambda *a: fn(xyz, mask, *a), *[jnp.asarray(a) for a in args[2:]])
    return jax.jit(vjp)(tuple(jnp.asarray(c) for c in cts))


@pytest.mark.parametrize("n_rbf", [20, 40])
@pytest.mark.parametrize("s", [3, 4])
def test_chunk_split_matches_jax_in_float64(monkeypatch, s, n_rbf):
    """The message and its VJP (d_phi, d_v, d_w) summed over the chunks, in
    float64, against the JAX package's message_reference and jax.vjp of it
    at rtol 1e-9: the split, the zero-padded tail and the bias function in
    the last chunk change nothing but the order of the sums."""
    args = tuple(a.astype(np.float64) for a in _inputs(11, s, n_rbf, seed=n_rbf + s))
    t = [torch.as_tensor(a) for a in args]
    cts = tuple(c.astype(np.float64) for c in _cotangents(mo.message_reference(
        *t, CUT, n_rbf), seed=n_rbf + s + 1))
    with jax.enable_x64(True):
        ref = functools.partial(pallas_message.message_reference, cutoff=CUT, n_rbf=n_rbf)
        want = ref(*[jnp.asarray(a) for a in args])
        want_vjp = _jax_vjp(ref, args, cts)
    got = chunked(mo.message_reference, t, n_rbf, monkeypatch)
    got_vjp = chunked(mo.message_vjp_reference, t + [torch.as_tensor(c) for c in cts], n_rbf,
                      monkeypatch)
    for a, b in zip(list(got) + list(got_vjp), list(want) + list(want_vjp)):
        assert np.asarray(b).dtype == np.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL64)
    # masked nodes get nothing and give no gradient
    for a in list(got) + list(got_vjp[:2]):
        assert float(a[:, -1].abs().max()) == 0.0


@pytest.mark.parametrize("s", [3, 4])
def test_chunk_split_matches_the_pallas_kernel_in_f32(monkeypatch, s):
    """At n_rbf 20 (two chunks of 11, one padded) in f32 against the Pallas
    kernel in interpret mode, as tests/test_pallas_message.py runs it, and
    jax.vjp of it (its hand-derived _bwd_kernel), at rtol 1e-4 / atol 1e-5."""
    n_rbf = 20
    args = _inputs(11, s, n_rbf, seed=40 + s)
    t = [torch.as_tensor(a) for a in args]
    cts = _cotangents(mo.message_reference(*t, CUT, n_rbf), seed=41 + s)
    kern = functools.partial(pallas_message.fused_message, cutoff=CUT, n_rbf=n_rbf, tile_i=8,
                             interpret=True)
    want = jax.jit(kern)(*[jnp.asarray(a) for a in args])
    want_vjp = _jax_vjp(kern, args, cts)
    got = chunked(mo.message_reference, t, n_rbf, monkeypatch)
    got_vjp = chunked(mo.message_vjp_reference, t + [torch.as_tensor(c) for c in cts], n_rbf,
                      monkeypatch)
    for a, b in zip(list(got) + list(got_vjp), list(want) + list(want_vjp)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=1e-5)
