"""Fused 9-channel chirality (pseudo) message: hand-written CUDA kernels,
forward and backward, and their plain twins.

Port of ``coarsegrainingvae_tpu/ops/pallas_pseudo.py``. The pseudo message
(models/dense_cgvae.DenseEquiMessagePseudo) runs on the CG graph of
M = n_cgs beads; the kernels (``csrc/fused_pseudo.cu``) keep the whole pair
pipeline (geometry, radial basis, envelope, adjacency, per-channel filters,
message combination) on chip:

    forward : xyz (B,M,3), mask (B,M), phi (B,M,9,F), s/sbar (B,M,F),
              v/vbar (B,M,3,F), w (R+1,9,F)
              -> ds/dsbar (B,M,F), dv/dvbar (B,M,3,F)
    backward: the same + gs/gsb (B,M,F), gv/gvb (B,M,3,F)
              -> d_phi, d_s, d_sbar, d_v, d_vbar, d_w (R+1,9,F) summed over B

Filter parameterization is the factored form: w[r, ch, f] with the last
basis row the bias, filt_ch(d) = env(d) * (sum_r rbf_r(d) w[r,ch] + w[R,ch]),
exactly DistanceEmbed's function class on one (R+1, 9, F) tensor.

The kernels take any n_rbf >= 1: R+1 in 2..16 as a template parameter,
past it on the wide path, whose basis comes in chunks of at most 9 functions
and which keeps nothing per basis function in shared memory.

``fused_pseudo_message`` is differentiable: one ``torch.autograd.Function``
pairs the forward kernel with the backward kernel (``fused_pseudo_vjp``) for
CUDA tensors, and ``pseudo_reference`` with ``pseudo_vjp_reference`` for CPU
tensors. xyz and mask get no gradient (pallas_pseudo.py:27-31).
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from coarsegrainingvae_tpu_torch.ops import LAUNCHES, cuda_build
from coarsegrainingvae_tpu_torch.ops.geometry import pair_filter_basis

# the sender payload of channels 2..8 (pallas_pseudo.py:54)
_CARRIES_V = {2: True, 3: False, 4: False, 5: False, 6: True, 7: True, 8: False}


def pseudo_reference(
    xyz: torch.Tensor,    # (B, M, 3)
    mask: torch.Tensor,   # (B, M)
    phi: torch.Tensor,    # (B, M, 9, F) pre-split per-node features
    s: torch.Tensor, sbar: torch.Tensor,        # (B, M, F)
    v: torch.Tensor, vbar: torch.Tensor,        # (B, M, 3, F)
    w: torch.Tensor,      # (R+1, 9, F)
    cutoff: float,
    n_rbf: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch semantics of the fused kernel (pallas_pseudo.py:77-117)."""
    unit, adj, k = pair_filter_basis(xyz, mask.to(xyz.dtype), cutoff, n_rbf)

    filt = torch.einsum("bijr,rcf->bijcf", k, w)       # (B,M,M,9,F)
    g = filt * phi[:, None, :, :, :]                   # sender j broadcast

    ds = s * torch.sum(g[..., 0, :], dim=2)
    dsbar = torch.sum(
        v * torch.sum(adj[..., None, None] * vbar[:, None], dim=2), dim=2
    )
    u1 = torch.sum(g[..., 1, None, :] * unit[..., :, None], dim=2)

    def agg(ch, x):   # sum_j g_ch[i,j,f] x[j,d,f]
        return torch.einsum("bijf,bjdf->bidf", g[..., ch, :], x)

    gate = sbar[:, :, None, :]
    dv = (u1 + agg(2, v) + torch.cross(v, agg(3, vbar), dim=-2)
          + gate * agg(4, vbar))
    dvbar = (
        agg(5, vbar) + gate * agg(6, v) + torch.cross(v, agg(7, v), dim=-2)
        + torch.cross(vbar, agg(8, vbar), dim=-2)
    )
    return ds, dsbar, dv, dvbar


def pseudo_vjp_reference(
    xyz: torch.Tensor, mask: torch.Tensor, phi: torch.Tensor,
    s: torch.Tensor, sbar: torch.Tensor, v: torch.Tensor, vbar: torch.Tensor,
    w: torch.Tensor,
    gs: torch.Tensor, gsb: torch.Tensor,      # (B, M, F) cotangents of ds, dsbar
    gv: torch.Tensor, gvb: torch.Tensor,      # (B, M, 3, F) of dv, dvbar
    cutoff: float, n_rbf: int,
) -> Tuple[torch.Tensor, ...]:
    """Plain torch transcription of the hand-derived VJP
    (pallas_pseudo.py::_bwd_kernel, :210-311): (d_phi, d_s, d_sbar, d_v,
    d_vbar, d_w), d_w summed over the batch."""
    unit, adj, k = pair_filter_basis(xyz, mask.to(xyz.dtype), cutoff, n_rbf)
    filt = torch.einsum("bijr,rcf->bijcf", k, w)       # (B,M,M,9,F)
    g = filt * phi[:, None]
    x = {True: v, False: vbar}

    def agg(ch):      # forward sum_j g_ch[i,j] x_ch[j]
        return torch.einsum("bijf,bjdf->bidf", g[..., ch, :], x[_CARRIES_V[ch]])

    a = {ch: agg(ch) for ch in (3, 4, 6, 7, 8)}
    s0 = torch.sum(g[..., 0, :], dim=2)
    t = torch.einsum("bij,bjdf->bidf", adj, vbar)
    gate = sbar[:, :, None, :]

    # receiver-side cotangents of the sums a_ch (pallas_pseudo.py:237-245)
    gamma = {2: gv, 3: torch.cross(gv, v, dim=-2), 4: gate * gv, 5: gvb,
             6: gate * gvb, 7: torch.cross(gvb, v, dim=-2),
             8: torch.cross(gvb, vbar, dim=-2)}

    d_s = s0 * gs
    d_sbar = torch.sum(a[4] * gv + a[6] * gvb, dim=2)
    # receiver side of the crosses, and the dsbar path in both roles
    d_v = (torch.cross(a[3], gv, dim=-2) + torch.cross(a[7], gvb, dim=-2)
           + gsb[:, :, None] * t)
    d_vbar = (torch.cross(a[8], gvb, dim=-2)
              + torch.einsum("bij,bidf->bjdf", adj, v * gsb[:, :, None]))

    # dG_ch[i, j]: the cotangent of g_ch for receiver i and sender j
    dg = [(s * gs)[:, :, None, :].expand_as(g[..., 0, :]),
          torch.einsum("bidf,bijd->bijf", gv, unit)]
    for ch in range(2, 9):
        dg.append(torch.einsum("bidf,bjdf->bijf", gamma[ch], x[_CARRIES_V[ch]]))
        # sender side: d_x[j] += sum_i g_ch[i, j] Gamma_ch[i]
        send = torch.einsum("bijf,bidf->bjdf", g[..., ch, :], gamma[ch])
        if _CARRIES_V[ch]:
            d_v = d_v + send
        else:
            d_vbar = d_vbar + send
    dg = torch.stack(dg, dim=3)                        # (B,M,M,9,F)
    d_phi = torch.sum(dg * filt, dim=1)
    d_w = torch.einsum("bijr,bijcf,bjcf->rcf", k, dg, phi)
    return d_phi, d_s, d_sbar, d_v, d_vbar, d_w


_SYMBOLS = {
    "fused_pseudo_fwd": (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_pseudo_bwd": (
        [ctypes.c_void_p] * 19 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_pseudo_bwd_partials": ([ctypes.c_int] * 3, ctypes.c_int),
}


def build():
    """Build (first call only) and load ``csrc/fused_pseudo.cu``."""
    return cuda_build.load("fused_pseudo", _SYMBOLS)


def _check_cuda_inputs(args: dict, n_rbf: int) -> Tuple[int, int, int]:
    """Shapes of a CUDA call: (B, M, F); raises on what the kernels do not
    take."""
    cuda_build.check_inputs(args, args["xyz"].device)
    b, m, _, f = args["phi"].shape
    if n_rbf < 1:
        raise ValueError(f"n_rbf must be at least 1, got {n_rbf}")
    node, vec = (b, m, f), (b, m, 3, f)
    expected = {"xyz": (b, m, 3), "mask": (b, m), "phi": (b, m, 9, f),
                "s": node, "sbar": node, "v": vec, "vbar": vec,
                "w": (n_rbf + 1, 9, f), "gs": node, "gsb": node, "gv": vec,
                "gvb": vec}
    for name, t in args.items():
        if tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {expected[name]}")
    return b, m, f


def _launch_forward(xyz, mask, phi, s, sbar, v, vbar, w, cutoff, n_rbf):
    b, m, f = _check_cuda_inputs(
        {"xyz": xyz, "mask": mask, "phi": phi, "s": s, "sbar": sbar, "v": v,
         "vbar": vbar, "w": w}, n_rbf)
    lib = build()
    device = xyz.device
    ds = torch.empty((b, m, f), dtype=torch.float32, device=device)
    dsbar = torch.empty_like(ds)
    dv = torch.empty((b, m, 3, f), dtype=torch.float32, device=device)
    dvbar = torch.empty_like(dv)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_pseudo_fwd(
            xyz.data_ptr(), mask.data_ptr(), phi.data_ptr(), s.data_ptr(),
            sbar.data_ptr(), v.data_ptr(), vbar.data_ptr(), w.data_ptr(),
            ds.data_ptr(), dsbar.data_ptr(), dv.data_ptr(), dvbar.data_ptr(),
            b, m, f, n_rbf + 1, float(cutoff), stream,
        )
    cuda_build.check(err, "fused_pseudo_message")
    LAUNCHES["fused_pseudo_message"] += 1
    return ds, dsbar, dv, dvbar


def fused_pseudo_vjp(
    xyz: torch.Tensor, mask: torch.Tensor, phi: torch.Tensor,
    s: torch.Tensor, sbar: torch.Tensor, v: torch.Tensor, vbar: torch.Tensor,
    w: torch.Tensor, gs: torch.Tensor, gsb: torch.Tensor, gv: torch.Tensor,
    gvb: torch.Tensor, cutoff: float, n_rbf: int,
) -> Tuple[torch.Tensor, ...]:
    """The pseudo message's VJP: (d_phi, d_s, d_sbar, d_v, d_vbar, d_w).

    CUDA tensors launch the backward kernel (counted in
    ``ops.LAUNCHES``); CPU tensors take
    ``pseudo_vjp_reference``.
    """
    device = xyz.device
    if device.type == "cpu":
        return pseudo_vjp_reference(xyz, mask, phi, s, sbar, v, vbar, w,
                                    gs, gsb, gv, gvb, cutoff, n_rbf)
    if device.type != "cuda":
        raise ValueError(f"fused_pseudo_vjp runs on cpu or cuda, not {device}")
    args = {"xyz": xyz, "mask": mask, "phi": phi, "s": s, "sbar": sbar,
            "v": v, "vbar": vbar, "w": w, "gs": gs, "gsb": gsb, "gv": gv,
            "gvb": gvb}
    b, m, f = _check_cuda_inputs(args, n_rbf)
    r_aug = n_rbf + 1
    lib = build()
    d_phi = torch.empty((b, m, 9, f), dtype=torch.float32, device=device)
    d_s = torch.empty((b, m, f), dtype=torch.float32, device=device)
    d_sbar = torch.empty_like(d_s)
    d_v = torch.empty((b, m, 3, f), dtype=torch.float32, device=device)
    d_vbar = torch.empty_like(d_v)
    # one partial d_w per frame group (M <= 6), per (batch element, node tile)
    # (M > 6) or, past R+1 = 16, per (frame group, node tile)
    parts = lib.fused_pseudo_bwd_partials(b, m, r_aug)
    dw_part = torch.empty((parts, r_aug, 9, f), dtype=torch.float32, device=device)
    d_w = torch.empty((r_aug, 9, f), dtype=torch.float32, device=device)
    outs = (d_phi, d_s, d_sbar, d_v, d_vbar, dw_part, d_w)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_pseudo_bwd(
            *(t.data_ptr() for t in args.values()),
            *(t.data_ptr() for t in outs),
            b, m, f, r_aug, float(cutoff), stream,
        )
    cuda_build.check(err, "fused_pseudo_vjp")
    LAUNCHES["fused_pseudo_vjp"] += 1
    return d_phi, d_s, d_sbar, d_v, d_vbar, d_w


class _FusedPseudo(torch.autograd.Function):
    """The forward kernel paired with its hand-derived backward kernel."""

    @staticmethod
    def forward(ctx, xyz, mask, phi, s, sbar, v, vbar, w, cutoff, n_rbf):
        ctx.save_for_backward(xyz, mask, phi, s, sbar, v, vbar, w)
        ctx.cutoff, ctx.n_rbf = cutoff, n_rbf
        if xyz.device.type == "cpu":
            return pseudo_reference(xyz, mask, phi, s, sbar, v, vbar, w,
                                    cutoff, n_rbf)
        return _launch_forward(xyz, mask, phi, s, sbar, v, vbar, w, cutoff, n_rbf)

    @staticmethod
    def backward(ctx, gs, gsb, gv, gvb):
        # upstream cotangents may arrive as non-contiguous views, or as
        # materialised zeros for an output nothing reads (the last layer's
        # dsbar and dvbar)
        grads = fused_pseudo_vjp(
            *ctx.saved_tensors, gs.contiguous(), gsb.contiguous(),
            gv.contiguous(), gvb.contiguous(), ctx.cutoff, ctx.n_rbf)
        return (None, None) + tuple(grads) + (None, None)


def fused_pseudo_message(
    xyz: torch.Tensor, mask: torch.Tensor, phi: torch.Tensor,
    s: torch.Tensor, sbar: torch.Tensor, v: torch.Tensor, vbar: torch.Tensor,
    w: torch.Tensor, cutoff: float, n_rbf: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused pseudo message: (ds, dsbar (B,M,F), dv, dvbar (B,M,3,F)),
    differentiable in phi, s, sbar, v, vbar and w.

    phi: (B, M, 9, F) pre-split per-node features; w: (R+1, 9, F) factored
    filter weights (last basis row = bias). All inputs float32. CUDA
    tensors launch the kernel (counted in ``ops.LAUNCHES``); CPU tensors
    take ``pseudo_reference``.
    """
    device = xyz.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_pseudo_message runs on cpu or cuda, not {device}")
    return _FusedPseudo.apply(xyz, mask, phi, s, sbar, v, vbar, w, cutoff, n_rbf)

