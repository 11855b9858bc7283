"""The pseudo kernels' wide path (R+1 > 16, csrc/fused_pseudo.cu): its
numerics and its loop order on the CPU, against the JAX package and the
plain versions.

The wide kernels cut the basis K = adj env [rbf_1..R, 1] into the fewest
chunks of at most kPseudoChunk functions, all of one width (the last
zero-padded), each built by pair_geometry.cuh::chunk_record (an accurate sin
and cos at the chunk's first angle and at the step, then the angle-addition
recurrence within the chunk; past R+1 = kExactFrom each function as the
plain version rounds it). Every output is linear in the filter, so each
chunk adds its share of the message and of its VJP to sums that stay in
registers across the chunks; the adjacency sums (t and the dsbar path) are
taken with the first chunk only. At M <= kWideRegMax they keep the register
path's layout (one frame per warp, each pair folded once for both
directions, one d_w partial per block of kWarps frames); past it the chunked
path's node tiles, with one d_w partial per (frame, node tile) written chunk
by chunk. The partials are summed in a fixed order.

(a) takes each chunk's share through the port's plain versions (the chunk's
basis in place of the whole one, the adjacency only in the first chunk),
sums the shares, and holds the sum against the JAX package's
pseudo_reference and jax.vjp of it in float64, and in f32 against the
Pallas kernel in interpret mode. (b) writes the kernels' loop order out in
torch (basis chunk x channel x pair at M <= 3; basis chunk x partner chunk x
node tile past it; batch, features and the thread's rows as tensor axes) and
holds it against the plain forward and autograd of it. (c) checks that the
chunk split covers every R+1 from 17 to 513 once with an instantiated width.
(d) holds the port's DenseCGVAE with a pseudo decoder at n_rbf 120 against
the JAX package's. The CUDA kernels
themselves are held against the plain versions on the card
(tests/test_torch_gpu.py, chip_smoke.py).
"""
import dataclasses
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po
from test_torch_message_wide import chunk_bases, chunk_values
from test_torch_model import batches  # noqa: F401  (the fixture)
from test_torch_pseudo_chunked import (BWD_CHUNK, FWD_CHUNK, SUMMED, _as64, _close32, _close64,
                                       _cotangents, _inputs, _jax_forward, _jax_vjp, held_rows,
                                       tiling)
from test_torch_pseudo_order import CARRIES_V, cross

torch.set_num_threads(1)

B, CUT = 3, 9.0
SOURCE = Path(__file__).resolve().parents[1] / "coarsegrainingvae_tpu_torch/csrc/fused_pseudo.cu"
TEXT = SOURCE.read_text()
CHUNK = int(re.search(r"constexpr int kPseudoChunk = (\d+);", TEXT).group(1))
# the wide register kernels take M <= REG_MAX, one frame per warp of WARPS
REG_MAX = int(re.search(r"constexpr int kWideRegMax = (\d+);", TEXT).group(1))
WARPS = int(re.search(r"constexpr int kWarps = (\d+);", TEXT).group(1))
# the chunk widths fused_pseudo.cu::with_wide instantiates
WIDTHS = {int(c) for c in re.findall(
    r"case (\d+): return fn\(std::integral_constant<int, \d+>\{\}\);",
    TEXT[TEXT.index("int with_wide("):])}
# the widest basis the tests hold the wide kernels to (the wrappers take any)
WIDEST = 512


def chunk_width(r_aug):
    """fused_pseudo.cu::with_wide: the fewest chunks of at most CHUNK
    functions, all of one width."""
    n = -(-r_aug // CHUNK)
    return -(-r_aug // n)


# (c) ------------------------------------------------------------------------


def test_chunks_cover_the_basis_once():
    """Every wide basis (R+1 from 17 to WIDEST + 1) splits into chunks of
    one width the kernels are instantiated for; the chunks r0 = 0, C, 2C, ...
    cover the functions 0 .. R once, the last one holds at least one
    function and the zero-padded tail is shorter than one chunk."""
    assert WIDTHS == {7, 8, 9} and CHUNK == max(WIDTHS)
    for r_aug in range(17, WIDEST + 2):
        width, n = chunk_width(r_aug), -(-r_aug // CHUNK)
        assert width in WIDTHS
        starts = list(range(0, r_aug, width))
        assert len(starts) == n
        covered = [j for r0 in starts for j in range(r0, min(r0 + width, r_aug))]
        assert covered == list(range(r_aug))
        assert 0 <= n * width - r_aug < width


# (a) ------------------------------------------------------------------------


def chunked(fn, args, n_rbf, monkeypatch):
    """fn (the port's pseudo_reference or pseudo_vjp_reference) chunk by
    chunk: each chunk's basis in place of the whole one and the adjacency
    in the first chunk only, the shares summed."""
    unit, adj, chunks = chunk_bases(args[0], args[1], CUT, n_rbf,
                                    width=chunk_width(n_rbf + 1))
    total = None
    for i, k in enumerate(chunks):
        a = adj if i == 0 else torch.zeros_like(adj)
        monkeypatch.setattr(po, "pair_filter_basis", lambda *_, k=k, a=a: (unit, a, k))
        share = fn(*args, CUT, n_rbf)
        total = share if total is None else [x + y for x, y in zip(total, share)]
    monkeypatch.undo()
    return total


@pytest.mark.parametrize("n_rbf", [16, 20, 95, 200])
@pytest.mark.parametrize("m", [3, 6, 10])
def test_chunk_split_matches_jax_in_float64(monkeypatch, m, n_rbf):
    """The message and its VJP (d_phi, d_s, d_sbar, d_v, d_vbar, d_w)
    summed over the chunks, in float64, against the JAX package's
    pseudo_reference and jax.vjp of it at rtol 1e-9 / atol 1e-9: the split,
    the zero-padded tail, the bias function in the last chunk and the
    adjacency sums in the first change nothing but the order of the sums."""
    args = _as64(_inputs(m, 24, n_rbf, seed=m + n_rbf))
    cts = _as64(_cotangents(m, 24))
    t = [torch.as_tensor(a) for a in args]
    with jax.enable_x64(True):
        want = _jax_forward(args, n_rbf)
        want_vjp = _jax_vjp(args, cts, n_rbf)
    got = chunked(po.pseudo_reference, t, n_rbf, monkeypatch)
    got_vjp = chunked(po.pseudo_vjp_reference, t + [torch.as_tensor(c) for c in cts], n_rbf,
                      monkeypatch)
    _close64(got, want)
    _close64(got_vjp, want_vjp)
    masked = args[1] == 0
    for x in list(got) + list(got_vjp[:5]):
        assert float(np.abs(x.numpy()[masked]).max()) == 0.0


@pytest.mark.parametrize("m", [3, 6, 10])
def test_chunk_split_matches_the_pallas_kernel_in_f32(monkeypatch, m):
    """At n_rbf 20 (three chunks of 7) in f32 against the Pallas kernel in
    interpret mode, as tests/test_pallas_pseudo.py runs it, and jax.vjp of
    it (its hand-derived _bwd_kernel): within 1e-4 of each output's max
    |ref| (chip_smoke.KERNEL_RTOL; tests/test_torch_pseudo_chunked.py says
    why not element by element)."""
    n_rbf = 20
    args, cts = _inputs(m, 24, n_rbf, seed=40 + m), _cotangents(m, 24)
    t = [torch.as_tensor(a) for a in args]
    got = chunked(po.pseudo_reference, t, n_rbf, monkeypatch)
    got_vjp = chunked(po.pseudo_vjp_reference, t + [torch.as_tensor(c) for c in cts], n_rbf,
                      monkeypatch)
    _close32(got, _jax_forward(args, n_rbf, interpret=True))
    _close32(got_vjp, _jax_vjp(args, cts, n_rbf, interpret=True))


# (b) ------------------------------------------------------------------------


def chunk_records(xyz, mask, p, q, r_aug, r0, width):
    """pair_geometry.cuh::chunk_record of rows p against partners q for the
    basis functions r0 .. r0 + width - 1 (zero past R+1; a row index of M or
    more gets a zero record): K (B, P, Q, width), unit (B, P, Q, 3), adj
    (B, P, Q)."""
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
    return chunk_values(d2, adj, r_aug, r0, width, CUT), unit, adj


def basis_chunks(w):
    """(r0, that chunk's w zero-padded to the chunk width) per basis chunk."""
    r_aug = w.shape[0]
    width = chunk_width(r_aug)
    pad = torch.cat([w, w.new_zeros(-(-r_aug // width) * width - r_aug, *w.shape[1:])])
    return [(r0, pad[r0:r0 + width]) for r0 in range(0, r_aug, width)]


def wide_forward_in_kernel_order(xyz, mask, phi, s, sbar, v, vbar, w):
    """fused_pseudo_wide_chunk_kernel: per node tile, per partner chunk, per
    basis chunk."""
    b, m, _, f = phi.shape
    tiles, rows, warps = tiling(m)
    r_aug = w.shape[0]
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
            for r0, wr in basis_chunks(w):
                k, unit, adj = chunk_records(xyz, mask, p, q, r_aug, r0, wr.shape[0])
                if r0 == 0:
                    t = t + torch.einsum("bpq,bqdf->bpdf", adj, vbar[:, q])
                gg = torch.einsum("bpqr,rcf->bpqcf", k, wr) * phi[:, None, q]
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


def wide_vjp_in_kernel_order(xyz, mask, phi, s, sbar, v, vbar, w, gs, gsb, gv, gvb):
    """fused_pseudo_bwd_wide_chunk_kernel: per node tile and frame (a tensor
    axis here), per basis chunk, per partner chunk, per channel; each
    chunk's rows of the (frame, tile) partial from the block's warps in a
    fixed order, the partials summed in sum_over_batch's order."""
    b, m, _, f = phi.shape
    tiles, rows, warps = tiling(m)
    r_aug = w.shape[0]
    d_phi, d_s, d_sbar = torch.zeros_like(phi), torch.zeros_like(s), torch.zeros_like(s)
    d_v, d_vbar = torch.zeros_like(v), torch.zeros_like(v)
    partials = w.new_zeros(b, tiles, r_aug, 9, f)
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
        for r0, wr in basis_chunks(w):
            width = wr.shape[0]
            dw = w.new_zeros(b, held, width, 9, f)   # each thread's d_w column
            for q0 in range(0, m, BWD_CHUNK):
                q = torch.arange(q0, min(m, q0 + BWD_CHUNK))
                k, unit, adj = chunk_records(xyz, mask, p, q, r_aug, r0, width)
                for ch in range(9):
                    filt = torch.einsum("bpqr,rf->bpqf", k, wr[:, ch])
                    ac = None
                    if ch == 0:         # dG = s gs; the dsbar path in the first chunk
                        if r0 == 0:
                            ac = torch.einsum("bpq,bqdf->bpdf", adj, vbar[:, q])
                            dvbs = dvbs + torch.einsum("bpq,bqdf->bpdf", adj,
                                                       gsb[:, q, None] * v[:, q])
                        dg = (s[:, q] * gs[:, q])[:, None].expand_as(filt)
                        s0 = s0 + (filt * phi[:, None, q, 0]).sum(2)
                    elif ch == 1:       # unit of (q <- p) is -unit of the record
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
                            ac = torch.einsum("bpqf,bqdf->bpdf", filt * phi[:, None, q, ch],
                                              x[:, q])
                    dph[:, :, ch] = dph[:, :, ch] + (filt * dg).sum(2)
                    dw[..., ch, :] = dw[..., ch, :] + torch.einsum(
                        "bpqr,bpqf->bprf", k, php[:, :, None, ch] * dg)
                    # the channel's gate on this chunk's forward sums
                    if ac is None:
                        continue
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
            # the block's warps' columns in a fixed order: this chunk's rows
            acc = w.new_zeros(b, width, 9, f)
            for row in range(held):
                acc = acc + dw[:, row]
            partials[:, tile, r0:r0 + width] = acc[:, :min(width, r_aug - r0)]
        n = min(rows, m - tile * rows)
        i = p[:n]
        d_phi[:, i], d_sbar[:, i] = dph[:, :n], dsb[:, :n]
        d_s[:, i] = s0[:, :n] * gs[:, i]
        d_v[:, i], d_vbar[:, i] = dvs[:, :n], dvbs[:, :n]
    d_w = w.new_zeros(r_aug, 9, f)
    for part in partials.reshape(b * tiles, r_aug, 9, f):   # sum_over_batch's order
        d_w = d_w + part
    return d_phi, d_s, d_sbar, d_v, d_vbar, d_w


def _autograd_vjp(args, cts, n_rbf):
    """autograd of the plain forward: the cotangents of phi, s, sbar, v,
    vbar and w."""
    t = [torch.as_tensor(a).clone() for a in args]
    for x in t[2:]:
        x.requires_grad_(True)
    out = po.pseudo_reference(*t, CUT, n_rbf)
    return torch.autograd.grad(out, t[2:], [torch.as_tensor(c) for c in cts])


# (M, F, n_rbf, B) of the wide chunked kernels (M > REG_MAX): one node tile
# at the sizes the register path takes below R+1 = 17 (4, 6), two tiles
# (10), nine tiles with three forward and five backward partner chunks (70);
# the chunk edges R+1 = 17 (two chunks of 9, padded), 21 (three of 7) and 28
# (four of 7), and R+1 = 131, past 32, whose functions round as the plain
# version does; B 70 at M 6
WIDE_CASES = [(4, 24, 16, 3), (5, 40, 20, 3), (6, 24, 27, 3), (10, 40, 20, 3),
              (70, 24, 16, 2), (6, 8, 20, 70), (4, 8, 130, 3)]


def _wide_inputs(m, f, n_rbf, b, seed):
    if b == B:
        return _inputs(m, f, n_rbf, seed)
    rng = np.random.default_rng(seed)
    mask = np.ones((b, m), np.float32)
    mask[::2, -1] = 0.0
    mask[-1] = 0.0

    def arr(*shape, scale=1.0):
        return (rng.normal(size=shape) * scale).astype(np.float32)

    return (arr(b, m, 3, scale=3.0), mask, arr(b, m, 9, f), arr(b, m, f), arr(b, m, f),
            arr(b, m, 3, f), arr(b, m, 3, f), arr(n_rbf + 1, 9, f, scale=0.3))


def _wide_cotangents(m, f, b, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(size=shape).astype(np.float32)
                 for shape in ((b, m, f), (b, m, f), (b, m, 3, f), (b, m, 3, f)))


@pytest.mark.parametrize("m,f,n_rbf,b", WIDE_CASES)
def test_wide_forward_in_kernel_order_matches_the_plain_forward(m, f, n_rbf, b):
    """Float64 within rtol 1e-9 / atol 1e-9 of pseudo_reference (another
    order of summation only); f32 within 1e-4 of each output's max."""
    args = _wide_inputs(m, f, n_rbf, b, seed=m + n_rbf + 100)
    t64 = [torch.as_tensor(a) for a in _as64(args)]
    _close64(wide_forward_in_kernel_order(*t64), po.pseudo_reference(*t64, CUT, n_rbf))
    t = [torch.as_tensor(a) for a in args]
    got = wide_forward_in_kernel_order(*t)
    _close32(got, po.pseudo_reference(*t, CUT, n_rbf))
    masked = args[1] == 0
    for x in got:
        assert float(np.abs(x.numpy()[masked]).max()) == 0.0


@pytest.mark.parametrize("m,f,n_rbf,b", WIDE_CASES)
def test_wide_vjp_in_kernel_order_matches_autograd(m, f, n_rbf, b):
    """d_phi, d_s, d_sbar, d_v, d_vbar and d_w (one partial per frame and
    node tile, the partials in a fixed order) against autograd of the
    plain forward: float64 within rtol 1e-9 / atol 1e-9, f32 within 1e-4
    of each output's max."""
    args = _wide_inputs(m, f, n_rbf, b, seed=m + n_rbf + 200)
    cts = _wide_cotangents(m, f, b, seed=m + 300)
    t64 = [torch.as_tensor(a) for a in _as64(args + cts)]
    _close64(wide_vjp_in_kernel_order(*t64), _autograd_vjp(_as64(args), _as64(cts), n_rbf))
    got = wide_vjp_in_kernel_order(*[torch.as_tensor(a) for a in args + cts])
    _close32(got, _autograd_vjp(args, cts, n_rbf))
    masked = args[1] == 0
    for grad in got[:5]:
        assert float(np.abs(grad.numpy()[masked]).max()) == 0.0


def _frame_pairs(xyz, mask):
    """The unordered pairs (a < c) of a frame's nodes and their squared
    distance (plus the epsilon), unit (B, P, 3) and adjacency (B, P)."""
    m = xyz.shape[1]
    pairs = [(a, c) for a in range(m) for c in range(a + 1, m)]
    ia = torch.tensor([a for a, _ in pairs], dtype=torch.long)
    ic = torch.tensor([c for _, c in pairs], dtype=torch.long)
    r = xyz[:, ic] - xyz[:, ia]
    d2 = (r * r).sum(-1) + 1e-3
    inv_d = torch.rsqrt(d2)
    adj = (d2 * inv_d < CUT).to(xyz.dtype) * mask[:, ia] * mask[:, ic]
    return pairs, d2, r * inv_d[..., None], adj


def wide_register_forward_in_kernel_order(xyz, mask, phi, s, sbar, v, vbar, w):
    """fused_pseudo_wide_reg_kernel (M <= 3): the dsbar sums with the first
    basis chunk; per basis chunk and channel, each unordered pair's filter
    folded once for both directions, the channel's gate on the chunk's
    share."""
    pairs, d2, unit, adj = _frame_pairs(xyz, mask)
    x = (v, vbar)
    ds, dsbar = torch.zeros_like(s), torch.zeros_like(s)
    dv, dvbar = torch.zeros_like(v), torch.zeros_like(v)
    for p, (a, c) in enumerate(pairs):
        dsbar[:, a] += adj[:, p, None] * (v[:, a] * vbar[:, c]).sum(1)
        dsbar[:, c] += adj[:, p, None] * (v[:, c] * vbar[:, a]).sum(1)
    for r0, wr in basis_chunks(w):
        k = chunk_values(d2, adj, w.shape[0], r0, wr.shape[0], CUT)     # (B, P, width)
        for ch in range(9):
            acc = torch.zeros_like(v)       # this chunk's share of the channel's sums
            xs = x[0 if CARRIES_V[ch] else 1]
            for p, (a, c) in enumerate(pairs):
                filt = k[:, p] @ wr[:, ch]
                ga, gc = filt * phi[:, c, ch], filt * phi[:, a, ch]
                if ch == 0:
                    acc[:, a, 0] += ga
                    acc[:, c, 0] += gc
                elif ch == 1:               # unit_ca = -unit_ac
                    acc[:, a] += ga[:, None] * unit[:, p, :, None]
                    acc[:, c] -= gc[:, None] * unit[:, p, :, None]
                else:
                    acc[:, a] += ga[:, None] * xs[:, c]
                    acc[:, c] += gc[:, None] * xs[:, a]
            gate = sbar[:, :, None]
            if ch == 0:
                ds = ds + s * acc[:, :, 0]
            elif ch in (1, 2):
                dv = dv + acc
            elif ch == 3:
                dv = dv + cross(v, acc)
            elif ch == 4:
                dv = dv + gate * acc
            elif ch == 5:
                dvbar = dvbar + acc
            elif ch == 6:
                dvbar = dvbar + gate * acc
            elif ch == 7:
                dvbar = dvbar + cross(v, acc)
            else:
                dvbar = dvbar + cross(vbar, acc)
    return ds, dsbar, dv, dvbar


def wide_register_vjp_in_kernel_order(xyz, mask, phi, s, sbar, v, vbar, w, gs, gsb, gv, gvb):
    """fused_pseudo_bwd_wide_reg_kernel (M <= 3): the dsbar path with the
    first basis chunk; per basis chunk and channel the pairs, the sums of
    d_phi across the chunks, the sender side and the gates on the chunk's
    share; each chunk's d_w summed over a block's WARPS frames (one per
    warp) in a fixed order into that block's partial, the partials summed
    in sum_over_batch's order."""
    b = xyz.shape[0]
    r_aug = w.shape[0]
    pairs, d2, unit, adj = _frame_pairs(xyz, mask)
    x = (v, vbar)
    sig = s * gs
    d_phi, s0 = torch.zeros_like(phi), torch.zeros_like(s)
    d_sbar, d_v, d_vbar = torch.zeros_like(s), torch.zeros_like(v), torch.zeros_like(v)
    dw_frame = w.new_zeros((b,) + tuple(w.shape))      # each frame's d_w
    d_x = (d_v, d_vbar)
    for p, (a, c) in enumerate(pairs):                 # the dsbar path
        ga, gc = adj[:, p, None] * gsb[:, a], adj[:, p, None] * gsb[:, c]
        d_v[:, a] += ga[:, None] * vbar[:, c]
        d_v[:, c] += gc[:, None] * vbar[:, a]
        d_vbar[:, a] += gc[:, None] * v[:, c]
        d_vbar[:, c] += ga[:, None] * v[:, a]
    gate = sbar[:, :, None]
    gamma = {2: gv, 3: cross(gv, v), 4: gate * gv, 5: gvb, 6: gate * gvb,
             7: cross(gvb, v), 8: cross(gvb, vbar)}
    for r0, wr in basis_chunks(w):
        width = wr.shape[0]
        k = chunk_values(d2, adj, r_aug, r0, width, CUT)
        dw_chunk = w.new_zeros(b, width, 9, w.shape[-1])
        for ch in range(9):
            xi = 0 if CARRIES_V[ch] else 1
            xs = x[xi]
            fa, bx = torch.zeros_like(v), torch.zeros_like(v)
            for p, (a, c) in enumerate(pairs):
                filt = k[:, p] @ wr[:, ch]
                ph_a, ph_c = phi[:, a, ch], phi[:, c, ch]
                if ch == 0:
                    dac, dca = sig[:, a], sig[:, c]
                    fa[:, a, 0] += filt * ph_c
                    fa[:, c, 0] += filt * ph_a
                elif ch == 1:
                    u = unit[:, p, :, None]
                    dac, dca = (gv[:, a] * u).sum(1), -(gv[:, c] * u).sum(1)
                else:
                    g_a, g_c = gamma[ch][:, a], gamma[ch][:, c]
                    dac, dca = (g_a * xs[:, c]).sum(1), (g_c * xs[:, a]).sum(1)
                    bx[:, c] += filt[:, None] * g_a
                    bx[:, a] += filt[:, None] * g_c
                    if ch not in (2, 5):
                        fa[:, a] += (filt * ph_c)[:, None] * xs[:, c]
                        fa[:, c] += (filt * ph_a)[:, None] * xs[:, a]
                d_phi[:, c, ch] += filt * dac
                d_phi[:, a, ch] += filt * dca
                dw_chunk[:, :, ch] += k[:, p, :, None] * (ph_c * dac + ph_a * dca)[:, None]
            if ch >= 2:
                d_x[xi].add_(phi[:, :, ch, None] * bx)
            if ch == 0:
                s0 += fa[:, :, 0]
            elif ch == 3:
                d_v += cross(fa, gv)
            elif ch == 4:
                d_sbar += (fa * gv).sum(2)
            elif ch == 6:
                d_sbar += (fa * gvb).sum(2)
            elif ch == 7:
                d_v += cross(fa, gvb)
            elif ch == 8:
                d_vbar += cross(fa, gvb)
        dw_frame[:, r0:r0 + width] = dw_chunk[:, :min(width, r_aug - r0)]
    groups = -(-b // WARPS)
    padded = w.new_zeros((groups * WARPS,) + tuple(w.shape))
    padded[:b] = dw_frame
    partials = padded.reshape(groups, WARPS, *w.shape).sum(1)
    d_w = w.new_zeros(w.shape)
    for part in partials:
        d_w = d_w + part
    return d_phi, s0 * gs, d_sbar, d_v, d_vbar, d_w


# (M, F, n_rbf, B) of the wide register kernels: M 1 to 3; B 9 leaves three
# warps of the last block without a frame; R+1 = 17, 21 and 131 (its
# functions rounding as the plain version does)
WIDE_REGISTER_CASES = [(3, 24, 20, 9), (2, 24, 16, 4), (3, 8, 130, 5), (1, 8, 20, 3)]


@pytest.mark.parametrize("m,f,n_rbf,b", WIDE_REGISTER_CASES)
def test_wide_register_kernels_in_kernel_order_match_the_plain_versions(m, f, n_rbf, b):
    """The forward against pseudo_reference and the VJP against autograd of
    it: float64 within rtol 1e-9 / atol 1e-9, f32 within 1e-4 of each
    output's max."""
    assert REG_MAX == 3 and m <= REG_MAX
    args = _wide_inputs(m, f, n_rbf, b, seed=m + n_rbf + 400)
    cts = _wide_cotangents(m, f, b, seed=m + 500)
    t64 = [torch.as_tensor(a) for a in _as64(args)]
    _close64(wide_register_forward_in_kernel_order(*t64), po.pseudo_reference(*t64, CUT, n_rbf))
    c64 = [torch.as_tensor(c) for c in _as64(cts)]
    _close64(wide_register_vjp_in_kernel_order(*t64, *c64),
             _autograd_vjp(_as64(args), _as64(cts), n_rbf))
    t = [torch.as_tensor(a) for a in args]
    _close32(wide_register_forward_in_kernel_order(*t), po.pseudo_reference(*t, CUT, n_rbf))
    _close32(wide_register_vjp_in_kernel_order(*t, *[torch.as_tensor(c) for c in cts]),
             _autograd_vjp(args, cts, n_rbf))


# (d) ------------------------------------------------------------------------


@pytest.mark.parametrize("impl", ["pallas", "default"])
def test_dense_model_with_a_pseudo_decoder_at_n_rbf_120_matches_jax(batches, monkeypatch,
                                                                     impl):
    """The port's DenseCGVAE (pseudo decoder, n_rbf 120: R+1 = 121, a basis
    the port's pseudo wrappers refused on the card before their wide path
    took chunks) against the JAX package's on converted parameters, on the
    CPU: the forward's fields and generate within rtol 1e-4 / atol 1e-5
    (f32, another order of summation; tests/test_torch_model.py's F32_TOL).
    The JAX side runs its Pallas kernels in interpret mode or its default
    einsum / stacked formulations."""
    from test_torch_model import (F32_TOL, FIELDS, _cfg, _eps, _init, _jax_forward,
                                  _jax_generate, _torch_model)

    jb, tb = batches
    cfg = dataclasses.replace(_cfg(impl), n_rbf=120)
    params = _init(cfg, jb)
    ref = _jax_forward(cfg, params, jb)
    eps = _eps()
    ref_gen = _jax_generate(cfg, params, jb, eps, monkeypatch)
    model = _torch_model(cfg, params)
    with torch.inference_mode():
        out = model(tb)
        gen = model.generate(tb, eps=torch.as_tensor(eps))
    for name in FIELDS:
        np.testing.assert_allclose(getattr(out, name).numpy(), ref[name], **F32_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(gen.numpy(), ref_gen, **F32_TOL)
