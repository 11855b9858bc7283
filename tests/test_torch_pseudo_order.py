"""The order in which csrc/fused_pseudo.cu computes the pseudo message,
transcribed to torch ops, against the plain versions.

The register path of the kernels (M <= 6) does not follow the plain
versions' order: it builds one geometry record per unordered pair with the
angle-addition recurrence, folds each pair's filter once for both
directions, applies each channel's gate at the channel's end, and sums d_w
per thread over pairs and frames, then over a block's warps, then over frame
groups. This file writes that order out in torch (one tensor op per line of
the kernel, features and frames as tensor axes) and holds it against
pseudo_reference and pseudo_vjp_reference at f32, so the rearranged math is
checked on the CPU; the kernels themselves are held against the plain
versions on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import math

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu_torch.ops.fused_pseudo import pseudo_reference, pseudo_vjp_reference

torch.set_num_threads(1)

F, CUT = 24, 8.5
RTOL = 1e-5                             # f32; another order of summation only
CARRIES_V = (False, False, True, False, False, False, True, True, False)
WARPS = 4                               # kWarps of the register path


def frames_per_warp(b):
    return max(1, min(8, b // 64))


def radial_basis(d, inv_d, adj, n_rbf, cut):
    """pair_geometry.cuh::pair_record's K (R+1 last): adj times the cosine
    envelope times sin((k + 1) pi d / cut) / d for k < n_rbf, then adj times
    the envelope, the sines by the angle-addition recurrence."""
    s1, c1 = torch.sin(math.pi / cut * d), torch.cos(math.pi / cut * d)
    ae = adj * (0.5 * (c1 + 1.0))
    k, sk, ck = [], s1, c1
    for _ in range(n_rbf):              # sin and cos of (k + 1) pi d / cutoff
        k.append(ae * inv_d * sk)
        sk, ck = sk * c1 + ck * s1, ck * c1 - sk * s1
    k.append(ae)
    return torch.stack(k, -1)


def pair_records(xyz, mask, n_rbf):
    """pair_geometry.cuh::pair_record for every unordered pair (a < c):
    (pairs, K (B, P, R+1), unit (B, P, 3), adj (B, P))."""
    m = xyz.shape[1]
    pairs = [(a, c) for a in range(m) for c in range(a + 1, m)]
    ia = torch.tensor([a for a, _ in pairs], dtype=torch.long)
    ic = torch.tensor([c for _, c in pairs], dtype=torch.long)
    r = xyz[:, ic] - xyz[:, ia]
    d2 = (r * r).sum(-1) + 1e-3
    inv_d = torch.rsqrt(d2)
    d = d2 * inv_d
    adj = (d < CUT).to(xyz.dtype) * mask[:, ia] * mask[:, ic]
    return pairs, radial_basis(d, inv_d, adj, n_rbf, CUT), r * inv_d[..., None], adj


def cross(a, b):
    return torch.cross(a, b, dim=-2)


def forward_in_kernel_order(xyz, mask, phi, s, sbar, v, vbar, w, n_rbf):
    pairs, k, unit, adj = pair_records(xyz, mask, n_rbf)
    x = (v, vbar)
    ds, dsbar = torch.zeros_like(s), torch.zeros_like(s)
    dv, dvbar = torch.zeros_like(v), torch.zeros_like(v)
    for p, (a, c) in enumerate(pairs):
        dsbar[:, a] += adj[:, p, None] * (v[:, a] * vbar[:, c]).sum(1)
        dsbar[:, c] += adj[:, p, None] * (v[:, c] * vbar[:, a]).sum(1)
    for ch in range(9):
        acc = torch.zeros_like(v)       # the channel's sum at each receiver
        xs = x[0 if CARRIES_V[ch] else 1]
        for p, (a, c) in enumerate(pairs):
            filt = k[:, p] @ w[:, ch]    # (B, F), folded once for both directions
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
            ds = s * acc[:, :, 0]
        elif ch in (1, 2):
            dv += acc
        elif ch == 3:
            dv += cross(v, acc)
        elif ch == 4:
            dv += gate * acc
        elif ch == 5:
            dvbar += acc
        elif ch == 6:
            dvbar += gate * acc
        elif ch == 7:
            dvbar += cross(v, acc)
        else:
            dvbar += cross(vbar, acc)
    return ds, dsbar, dv, dvbar


def vjp_in_kernel_order(xyz, mask, phi, s, sbar, v, vbar, w, gs, gsb, gv, gvb, n_rbf):
    b = xyz.shape[0]
    pairs, k, unit, adj = pair_records(xyz, mask, n_rbf)
    x = (v, vbar)
    sig = s * gs
    d_phi, d_s = torch.zeros_like(phi), torch.zeros_like(s)
    d_sbar, d_v, d_vbar = torch.zeros_like(s), torch.zeros_like(v), torch.zeros_like(v)
    dw_frame = torch.zeros((b,) + tuple(w.shape))      # each frame's d_w
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
    for ch in range(9):
        xi = 0 if CARRIES_V[ch] else 1
        xs = x[xi]
        fa, bx = torch.zeros_like(v), torch.zeros_like(v)
        dph = torch.zeros_like(s)
        for p, (a, c) in enumerate(pairs):
            filt = k[:, p] @ w[:, ch]
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
            dph[:, c] += filt * dac
            dph[:, a] += filt * dca
            dw_frame[:, :, ch] += k[:, p, :, None] * (ph_c * dac + ph_a * dca)[:, None]
        d_phi[:, :, ch] = dph
        if ch >= 2:
            d_x[xi].add_(phi[:, :, ch, None] * bx)
        if ch == 0:
            d_s = fa[:, :, 0] * gs
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
    # d_w: per thread over its frames, per block over its warps, then
    # sum_over_batch over the frame groups, each in a fixed order
    fpw = frames_per_warp(b)
    group = WARPS * fpw
    n_groups = (b + group - 1) // group
    padded = torch.zeros((n_groups * group,) + tuple(w.shape))
    padded[:b] = dw_frame
    per_thread = padded.reshape(n_groups, fpw, WARPS, *w.shape).sum(1)
    d_w = per_thread.sum(1).sum(0)
    return d_phi, d_s, d_sbar, d_v, d_vbar, d_w


def _inputs(b, m, n_rbf, seed, masked_frame=False):
    rng = np.random.default_rng(seed)

    def arr(*shape, scale=1.0):
        return torch.as_tensor((rng.normal(size=shape) * scale).astype(np.float32))

    mask = np.ones((b, m), np.float32)
    mask[::2, -1] = 0.0
    if masked_frame:
        mask[-1] = 0.0
    args = (arr(b, m, 3, scale=3.0), torch.as_tensor(mask), arr(b, m, 9, F), arr(b, m, F),
            arr(b, m, F), arr(b, m, 3, F), arr(b, m, 3, F), arr(n_rbf + 1, 9, F, scale=0.3))
    cts = (arr(b, m, F), arr(b, m, F), arr(b, m, 3, F), arr(b, m, 3, F))
    return args, cts


def _close(out, ref):
    for a, r in zip(out, ref):
        assert a.shape == r.shape
        assert float((a - r).abs().max()) <= RTOL * float(r.abs().max())


# M up to the register path's cap of 6; n_rbf at the kernels' ends; B 130
# spans 17 frame groups of 8 frames, the last with 2
CASES = [(3, 2, 6), (5, 3, 8), (3, 4, 1), (6, 6, 15), (130, 3, 8), (9, 5, 8)]


@pytest.mark.parametrize("b,m,n_rbf", CASES)
def test_forward_in_kernel_order_matches_plain(b, m, n_rbf):
    args, _ = _inputs(b, m, n_rbf, seed=b + 10 * m + n_rbf)
    _close(forward_in_kernel_order(*args, n_rbf), pseudo_reference(*args, CUT, n_rbf))


@pytest.mark.parametrize("b,m,n_rbf", CASES)
def test_vjp_in_kernel_order_matches_plain(b, m, n_rbf):
    args, cts = _inputs(b, m, n_rbf, seed=b + 10 * m + n_rbf + 1)
    _close(vjp_in_kernel_order(*args, *cts, n_rbf), pseudo_vjp_reference(*args, *cts, CUT, n_rbf))


def test_masked_frame_gives_exact_zeros_in_kernel_order():
    """A fully masked frame: no pair has K or adj, so every output and
    every gradient of that frame is exactly zero, and d_w is that of the
    other frames."""
    args, cts = _inputs(4, 3, 8, seed=5, masked_frame=True)
    full = vjp_in_kernel_order(*args, *cts, 8)
    for t in forward_in_kernel_order(*args, 8) + full[:5]:
        assert float(t[-1].abs().max()) == 0.0
    head = vjp_in_kernel_order(*[a[:3] for a in args[:7]], args[7], *[c[:3] for c in cts], 8)
    _close(full[5:], head[5:])
