"""The blocking of csrc/fused_pseudo.cu's chunked path (M > 6), transcribed
to torch ops, against the JAX package's pseudo message and its VJP.

The chunked kernels split the M beads into node tiles (kTileRows nodes per
thread, at most kTileWarps warps per block), walk the partners in chunks
staged in shared memory (kFwdChunk in the forward, kBwdChunk in the
backward), build each (tile node, chunk partner) geometry record once per
chunk with the angle-addition recurrence, and in the backward walk the nine
channels per chunk, apply each channel's gate to the chunk's forward sums at
the channel's end, keep one d_w partial per (batch element, node tile) and
add the partials in a fixed order. This file writes that order out in torch
(one tensor op per step of the kernels; batch, features and the thread's
rows as tensor axes) and holds it against the JAX package's
``fused_pseudo_message`` (the Pallas kernel in interpret mode, as
tests/test_pallas_pseudo.py runs it) and its jnp reference, forward and
VJP: in float64 element by element, which holds the blocking's algebra
with rounding out of the way, and in f32 within 1e-4 of each output's max,
the gate the kernels meet on the card. In f32 an element by element
tolerance of rtol 1e-4 / atol 1e-5 does not hold between two orders of
summation at these sizes: an output element near zero sums ~100 partners,
and d_w sums tens of thousands of pair terms, so the two orders' rounding
alone differs by up to 7e-5 there. The kernels themselves are held against
the plain versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import functools
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.ops import pallas_pseudo
from test_torch_pseudo_order import CARRIES_V, cross, radial_basis

torch.set_num_threads(1)

B, CUT = 3, 9.0
# float64: another order of summation and the radial sines' recurrence only
TOL64 = dict(rtol=1e-9, atol=1e-9)
# f32: max |a - b| <= RTOL32 max |b| per output (chip_smoke.KERNEL_RTOL)
RTOL32 = 1e-4
SUMMED = (3, 4, 6, 7, 8)                # channels whose forward sum a gate reads

SOURCE = Path(__file__).resolve().parents[1] / "coarsegrainingvae_tpu_torch/csrc/fused_pseudo.cu"


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE.read_text()).group(1))


TILE_ROWS, TILE_WARPS = _constant("kTileRows"), _constant("kTileWarps")
FWD_CHUNK, BWD_CHUNK = _constant("kFwdChunk"), _constant("kBwdChunk")


def tiling(m):
    """fused_pseudo.cu::chunk_tiling: (tiles, rows per tile, warps)."""
    cap = TILE_ROWS * TILE_WARPS
    tiles = -(-m // cap)
    rows = -(-m // tiles)
    return tiles, rows, -(-rows // TILE_ROWS)


def records(xyz, mask, p, q, n_rbf):
    """pair_geometry.cuh::pair_record of rows p against partners q (a row
    index of M or more gets a zero record): K (B, P, Q, R+1), unit
    (B, P, Q, 3), adj (B, P, Q)."""
    m = xyz.shape[1]
    valid = (p < m)[:, None] & (q < m)[None, :]
    pc = p.clamp(max=m - 1)
    r = xyz[:, None, q] - xyz[:, pc, None]
    d2 = (r * r).sum(-1) + 1e-3
    inv_d = torch.rsqrt(d2)
    d = d2 * inv_d
    unit = r * inv_d[..., None] * valid[..., None]
    inside = valid & (p[:, None] != q[None, :]) & (d < CUT)
    adj = inside * mask[:, pc, None] * mask[:, None, q]
    return radial_basis(d, inv_d, adj, n_rbf, CUT), unit, adj


def held_rows(tile, rows, warps, m):
    """The node of each row the block's threads hold (warp-major, kTileRows
    per thread); rows past the tile are M, so their records are zero."""
    rr = torch.arange(warps * TILE_ROWS)
    return torch.where(rr < rows, tile * rows + rr, torch.full_like(rr, m))


def forward_in_chunked_order(xyz, mask, phi, s, sbar, v, vbar, w, n_rbf):
    b, m, _, f = phi.shape
    tiles, rows, warps = tiling(m)
    ds, dsbar = torch.zeros_like(s), torch.zeros_like(s)
    dv, dvbar = torch.zeros_like(v), torch.zeros_like(v)
    for tile in range(tiles):
        p = held_rows(tile, rows, warps, m)
        held = len(p)
        s0 = s.new_zeros(b, held, f)
        t, dvd, dvbd = (v.new_zeros(b, held, 3, f) for _ in range(3))
        a = {ch: v.new_zeros(b, held, 3, f) for ch in SUMMED}
        for j0 in range(0, m, FWD_CHUNK):
            q = torch.arange(j0, min(m, j0 + FWD_CHUNK))
            k, unit, adj = records(xyz, mask, p, q, n_rbf)
            t = t + torch.einsum("bpq,bqdf->bpdf", adj, vbar[:, q])
            gg = torch.einsum("bpqr,rcf->bpqcf", k, w) * phi[:, None, q]
            s0 = s0 + gg[..., 0, :].sum(2)
            dvd = (dvd + torch.einsum("bpqf,bpqd->bpdf", gg[..., 1, :], unit)
                   + torch.einsum("bpqf,bqdf->bpdf", gg[..., 2, :], v[:, q]))
            dvbd = dvbd + torch.einsum("bpqf,bqdf->bpdf", gg[..., 5, :], vbar[:, q])
            for ch in SUMMED:
                x = v if CARRIES_V[ch] else vbar
                a[ch] = a[ch] + torch.einsum("bpqf,bqdf->bpdf", gg[..., ch, :], x[:, q])
        n = min(rows, m - tile * rows)
        i = p[:n]
        gi = sbar[:, i, None]
        ds[:, i] = s[:, i] * s0[:, :n]
        dsbar[:, i] = (v[:, i] * t[:, :n]).sum(2)
        dv[:, i] = dvd[:, :n] + cross(v[:, i], a[3][:, :n]) + gi * a[4][:, :n]
        dvbar[:, i] = (dvbd[:, :n] + gi * a[6][:, :n] + cross(v[:, i], a[7][:, :n])
                       + cross(vbar[:, i], a[8][:, :n]))
    return ds, dsbar, dv, dvbar


def vjp_in_chunked_order(xyz, mask, phi, s, sbar, v, vbar, w, gs, gsb, gv, gvb, n_rbf):
    b, m, _, f = phi.shape
    tiles, rows, warps = tiling(m)
    ra = n_rbf + 1
    d_phi, d_s, d_sbar = torch.zeros_like(phi), torch.zeros_like(s), torch.zeros_like(s)
    d_v, d_vbar = torch.zeros_like(v), torch.zeros_like(v)
    partials = w.new_zeros(b, tiles, ra, 9, f)
    gamma_of = {2: lambda q: gv[:, q], 5: lambda q: gvb[:, q],
                3: lambda q: cross(gv[:, q], v[:, q]), 4: lambda q: sbar[:, q, None] * gv[:, q],
                6: lambda q: sbar[:, q, None] * gvb[:, q], 7: lambda q: cross(gvb[:, q], v[:, q]),
                8: lambda q: cross(gvb[:, q], vbar[:, q])}
    for tile in range(tiles):
        p = held_rows(tile, rows, warps, m)
        pc = p.clamp(max=m - 1)         # the thread's node inputs (clamped past M)
        held = len(p)
        xp = {True: v[:, pc], False: vbar[:, pc]}
        php, gvp, gvbp, gsbp = phi[:, pc], gv[:, pc], gvb[:, pc], gsb[:, pc, None]
        dph = phi.new_zeros(b, held, 9, f)
        dvs, dvbs = v.new_zeros(b, held, 3, f), v.new_zeros(b, held, 3, f)
        dsb, s0 = s.new_zeros(b, held, f), s.new_zeros(b, held, f)
        dw = w.new_zeros(b, held, ra, 9, f)     # each thread's d_w column
        for q0 in range(0, m, BWD_CHUNK):
            q = torch.arange(q0, min(m, q0 + BWD_CHUNK))
            k, unit, adj = records(xyz, mask, p, q, n_rbf)
            for ch in range(9):
                filt = torch.einsum("bpqr,rf->bpqf", k, w[:, ch])
                if ch == 0:             # the dsbar path, both roles; dG = s gs
                    ac = torch.einsum("bpq,bqdf->bpdf", adj, vbar[:, q])
                    dvbs = dvbs + torch.einsum("bpq,bqdf->bpdf", adj,
                                               gsb[:, q, None] * v[:, q])
                    dg = (s[:, q] * gs[:, q])[:, None].expand_as(filt)
                    s0 = s0 + (filt * phi[:, None, q, 0]).sum(2)
                elif ch == 1:           # unit of (q <- p) is -unit of the record
                    dg = -torch.einsum("bqdf,bpqd->bpqf", gv[:, q], unit)
                else:
                    gam = gamma_of[ch](q)
                    dg = torch.einsum("bqdf,bpdf->bpqf", gam, xp[CARRIES_V[ch]])
                    send = torch.einsum("bpqf,bqdf->bpdf", filt * php[:, :, None, ch], gam)
                    if CARRIES_V[ch]:
                        dvs = dvs + send
                    else:
                        dvbs = dvbs + send
                    if ch in SUMMED:
                        x = v if CARRIES_V[ch] else vbar
                        ac = torch.einsum("bpqf,bqdf->bpdf", filt * phi[:, None, q, ch], x[:, q])
                dph[:, :, ch] = dph[:, :, ch] + (filt * dg).sum(2)
                dw[..., ch, :] = dw[..., ch, :] + torch.einsum(
                    "bpqr,bpqf->bprf", k, php[:, :, None, ch] * dg)
                # the channel's gate on the chunk's forward sums
                if ch == 0:
                    dvs = dvs + gsbp * ac
                elif ch == 3:
                    dvs = dvs + cross(ac, gvp)
                elif ch == 4:
                    dsb = dsb + (ac * gvp).sum(2)
                elif ch == 6:
                    dsb = dsb + (ac * gvbp).sum(2)
                elif ch == 7:
                    dvs = dvs + cross(ac, gvbp)
                elif ch == 8:
                    dvbs = dvbs + cross(ac, gvbp)
        for row in range(held):         # the block's warps' columns in a fixed order
            partials[:, tile] = partials[:, tile] + dw[:, row]
        n = min(rows, m - tile * rows)
        i = p[:n]
        d_phi[:, i], d_sbar[:, i] = dph[:, :n], dsb[:, :n]
        d_s[:, i] = s0[:, :n] * gs[:, i]
        d_v[:, i], d_vbar[:, i] = dvs[:, :n], dvbs[:, :n]
    d_w = w.new_zeros(ra, 9, f)
    for part in partials.reshape(b * tiles, ra, 9, f):   # sum_over_batch's order
        d_w = d_w + part
    return d_phi, d_s, d_sbar, d_v, d_vbar, d_w


def _inputs(m, f, n_rbf, seed):
    """Tail bead masked in every frame, and the last frame fully masked."""
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    mask = np.ones((B, m), np.float32)
    mask[:, -1] = 0.0
    mask[-1] = 0.0
    return (arr(B, m, 3, scale=3.0), mask, arr(B, m, 9, f), arr(B, m, f), arr(B, m, f),
            arr(B, m, 3, f), arr(B, m, 3, f), arr(n_rbf + 1, 9, f, scale=0.3))


# (M, F, n_rbf): one node tile (7) and two (10) at the first chunked sizes,
# one 64-partner span exactly and one past it (64, 65: backward chunks of 16
# and forward chunks of 32 end there), several tiles and chunks (100); F not
# a multiple of the kernels' 32 features; the templated R+1 at its ends
CASES = [(7, 40, 1), (10, 40, 15), (64, 24, 8), (65, 40, 1), (100, 40, 15)]


def test_tiling_covers_every_node_once():
    """Tiles of at most TILE_ROWS * TILE_WARPS nodes, split evenly, cover
    0 .. M - 1 once; the shape table's sizes fill 13 and 38 tiles."""
    for m in range(7, 400):
        tiles, rows, warps = tiling(m)
        assert rows <= TILE_ROWS * TILE_WARPS and warps <= TILE_WARPS
        assert (tiles - 1) * rows < m <= tiles * rows <= warps * TILE_ROWS * tiles
    assert tiling(10) == (2, 5, 3) and tiling(100) == (13, 8, 4) and tiling(300) == (38, 8, 4)


def _cotangents(m, f):
    rng = np.random.default_rng(m + 7)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((B, m, f), (B, m, f), (B, m, 3, f), (B, m, 3, f)))


def _jax_forward(args, n_rbf, interpret=False):
    jargs = [jnp.asarray(a) for a in args]
    if interpret:                       # the Pallas kernel, as tests/test_pallas_pseudo.py runs it
        return jax.jit(functools.partial(pallas_pseudo.fused_pseudo_message, cutoff=CUT,
                                         n_rbf=n_rbf, tile_b=8, interpret=True))(*jargs)
    return pallas_pseudo.pseudo_reference(*jargs, CUT, n_rbf)


def _jax_vjp(args, cts, n_rbf, interpret=False):
    fn = (functools.partial(pallas_pseudo.fused_pseudo_message, cutoff=CUT, n_rbf=n_rbf,
                            tile_b=8, interpret=True) if interpret
          else functools.partial(pallas_pseudo.pseudo_reference, cutoff=CUT, n_rbf=n_rbf))
    xyz, mask = jnp.asarray(args[0]), jnp.asarray(args[1])
    _, vjp = jax.vjp(lambda *a: fn(xyz, mask, *a), *[jnp.asarray(a) for a in args[2:]])
    return jax.jit(vjp)(tuple(jnp.asarray(c) for c in cts))


def _close32(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert a.shape == b.shape
        assert np.abs(a.numpy() - b).max() <= RTOL32 * np.abs(b).max()


def _close64(got, want):
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert b.dtype == np.float64
        np.testing.assert_allclose(a.numpy(), b, **TOL64)


def _as64(arrays):
    return tuple(a.astype(np.float64) for a in arrays)


@pytest.mark.parametrize("m,f,n_rbf", CASES)
def test_chunked_forward_matches_jax(m, f, n_rbf):
    args = _inputs(m, f, n_rbf, seed=m + n_rbf)
    with jax.enable_x64(True):
        want64 = _jax_forward(_as64(args), n_rbf)
    _close64(forward_in_chunked_order(*[torch.as_tensor(a) for a in _as64(args)], n_rbf), want64)
    got = forward_in_chunked_order(*[torch.as_tensor(a) for a in args], n_rbf)
    _close32(got, _jax_forward(args, n_rbf))
    if m <= 10:
        _close32(got, _jax_forward(args, n_rbf, interpret=True))
    masked = args[1] == 0
    for a in got:
        assert float(np.abs(a.numpy()[masked]).max()) == 0.0


@pytest.mark.parametrize("m,f,n_rbf", CASES)
def test_chunked_vjp_matches_jax(m, f, n_rbf):
    """d_phi, d_s, d_sbar, d_v, d_vbar and d_w (its per-(frame, node tile)
    partials added in a fixed order) against jax.vjp of the JAX package's
    pseudo message: the jnp reference, and at M <= 10 the Pallas kernel in
    interpret mode (its hand-derived _bwd_kernel)."""
    args, cts = _inputs(m, f, n_rbf, seed=m + n_rbf + 1), _cotangents(m, f)
    with jax.enable_x64(True):
        want64 = _jax_vjp(_as64(args), _as64(cts), n_rbf)
    _close64(vjp_in_chunked_order(*[torch.as_tensor(a) for a in _as64(args + cts)], n_rbf),
             want64)
    got = vjp_in_chunked_order(*[torch.as_tensor(a) for a in args + cts], n_rbf)
    _close32(got, _jax_vjp(args, cts, n_rbf))
    if m <= 10:
        _close32(got, _jax_vjp(args, cts, n_rbf, interpret=True))
    masked = args[1] == 0
    for grad in got[:5]:
        assert float(np.abs(grad.numpy()[masked]).max()) == 0.0
