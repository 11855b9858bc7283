"""Fused factored PaiNN message: hand-written CUDA kernels, forward and
backward, and their plain twins.

Port of ``coarsegrainingvae_tpu/ops/pallas_message.py``. The factored message
(models/dense.DenseFactoredEquiMessage) reads per-node features and produces
per-node aggregates; everything pairwise (distances, radial basis, envelope,
adjacency, per-basis filters) stays inside the kernels
(``csrc/fused_message.cu``):

    forward : xyz (B,N,3), mask (B,N), phi (B,N,S,F), v (B,N,3,F), w (R+1,S,F)
              -> ds (B,N,F), dv (B,N,3,F)
    backward: the same + gs (B,N,F), gv (B,N,3,F)
              -> d_phi (B,N,S,F), d_v (B,N,3,F), d_w (R+1,S,F) summed over B

The kernels take any n_rbf >= 1: R+1 in 2..16 as a template parameter,
past it on the wide path, whose basis comes in chunks of at most 12
functions and which keeps nothing per basis function in shared memory. At
S = 3, R+1 <= 16 and many nodes (the library's ``fused_message_route``
says which launches) the forward takes the tensor-core kernel, counted
also as ``fused_message_tc`` in ``ops.LAUNCHES``.

``fused_message`` is differentiable: one ``torch.autograd.Function`` pairs
the forward kernel with the backward kernel (``fused_message_vjp``) for
CUDA tensors, and ``message_reference`` with ``message_vjp_reference`` for
CPU tensors; there is no other fallback. As in the JAX package
(pallas_message.py:38-42), xyz and mask get no gradient: the message graphs
are built from data, never from parameters.
"""
from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from coarsegrainingvae_tpu_torch.ops import LAUNCHES, cuda_build
from coarsegrainingvae_tpu_torch.ops.geometry import pair_filter_basis


def message_reference(
    xyz: torch.Tensor,    # (B, N, 3)
    mask: torch.Tensor,   # (B, N) bool/float
    phi: torch.Tensor,    # (B, N, S, F), S = 4 (cross) or 3
    v: torch.Tensor,      # (B, N, 3, F)
    w: torch.Tensor,      # (R+1, S, F)
    cutoff: float,
    n_rbf: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain torch semantics of the fused kernel (pallas_message.py:72-113)."""
    cross = phi.shape[2] == 4
    unit, _, k = pair_filter_basis(xyz, mask.to(xyz.dtype), cutoff, n_rbf)

    g_b = torch.einsum("bijr,bjf->birf", k, phi[:, :, 1])
    ds = torch.einsum("birf,rf->bif", g_b, w[:, 1])

    ku = torch.einsum("bijr,bijd->bijrd", k, unit)
    g_c = torch.einsum("bijrd,bjf->birdf", ku, phi[:, :, 2])
    dv = torch.einsum("birdf,rf->bidf", g_c, w[:, 2])

    p_a = phi[:, :, 0][:, :, None, :] * v
    g_a = torch.einsum("bijr,bjdf->birdf", k, p_a)
    dv = dv + torch.einsum("birdf,rf->bidf", g_a, w[:, 0])

    if cross:
        p_3 = phi[:, :, 3][:, :, None, :] * v
        g_3 = torch.einsum("bijr,bjdf->birdf", k, p_3)
        w3 = torch.einsum("birdf,rf->bidf", g_3, w[:, 3])
        dv = dv + torch.cross(v, w3, dim=-2)
    return ds, dv


def message_vjp_reference(
    xyz: torch.Tensor, mask: torch.Tensor, phi: torch.Tensor,
    v: torch.Tensor, w: torch.Tensor,
    gs: torch.Tensor,     # (B, N, F) cotangent of ds
    gv: torch.Tensor,     # (B, N, 3, F) cotangent of dv
    cutoff: float, n_rbf: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain torch transcription of the hand-derived VJP
    (pallas_message.py::_bwd_kernel, :202-342): (d_phi, d_v, d_w), d_w summed
    over the batch. K[i, j] is symmetric, so the per-basis contraction of a
    cotangent over receivers i is the forward's contraction over senders.
    """
    cross = phi.shape[2] == 4
    unit, _, k = pair_filter_basis(xyz, mask.to(xyz.dtype), cutoff, n_rbf)

    def fold(g, ws):        # (B,N,R+1,[3,]F) x (R+1,F) -> (B,N,[3,]F)
        return torch.einsum("bjr...f,rf->bj...f", g, ws)

    # scalar channel: t = gs_i
    g1 = torch.einsum("bijr,bif->bjrf", k, gs)
    # unit channel: t = gv_i . unit_ij (unit of the receiver i)
    g2 = torch.einsum("bijr,bijd,bidf->bjrf", k, unit, gv)
    # sender-vector channel: per-axis contraction of gv
    g0 = torch.einsum("bijr,bidf->bjrdf", k, gv)
    a0 = fold(g0, w[:, 0])                                   # (B,N,3,F)

    d_phi = [torch.sum(v * a0, dim=2), fold(g1, w[:, 1]), fold(g2, w[:, 2])]
    d_v = phi[:, :, 0, None] * a0
    d_w = [torch.einsum("bjrdf,bjdf,bjf->rf", g0, v, phi[:, :, 0]),
           torch.einsum("bjrf,bjf->rf", g1, phi[:, :, 1]),
           torch.einsum("bjrf,bjf->rf", g2, phi[:, :, 2])]
    if cross:
        # dv_i += v_i x w3_i: the cotangent of w3_i is gv_i x v_i, and v_i
        # itself gets w3_i x gv_i
        gam3 = torch.cross(gv, v, dim=-2)
        g3 = torch.einsum("bijr,bidf->bjrdf", k, gam3)
        a3 = fold(g3, w[:, 3])
        d_phi.append(torch.sum(v * a3, dim=2))
        w3 = fold(torch.einsum("bijr,bjdf->birdf", k, phi[:, :, 3, None] * v), w[:, 3])
        d_v = d_v + phi[:, :, 3, None] * a3 + torch.cross(w3, gv, dim=-2)
        d_w.append(torch.einsum("bjrdf,bjdf,bjf->rf", g3, v, phi[:, :, 3]))
    return torch.stack(d_phi, dim=2), d_v, torch.stack(d_w, dim=1)


_SYMBOLS = {
    "fused_message_fwd": (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_message_bwd": (
        [ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p],
        ctypes.c_int,
    ),
    "fused_message_bwd_tiles": ([ctypes.c_int], ctypes.c_int),
    "fused_message_bwd_partials": ([ctypes.c_int] * 3, ctypes.c_int),
    "fused_message_route": ([ctypes.c_int] * 4, ctypes.c_int),
}


def build():
    """Build (first call only) and load ``csrc/fused_message.cu``."""
    return cuda_build.load("fused_message", _SYMBOLS)


def tensor_core_route(b: int, n: int, s: int, n_rbf: int) -> bool:
    """Whether a CUDA forward launch of (B, N, S, n_rbf) takes the
    tensor-core kernel: the library's own rule (``fused_message_route``;
    builds it)."""
    return bool(build().fused_message_route(b, n, s, n_rbf + 1))


def _check_cuda_inputs(args: dict, n_rbf: int) -> Tuple[int, int, int, int]:
    """Shapes of a CUDA call: (B, N, S, F); raises on what the kernels do
    not take."""
    device = args["xyz"].device
    cuda_build.check_inputs(args, device)
    b, n, s, f = args["phi"].shape
    if s not in (3, 4):
        raise ValueError(f"phi must have S = 3 or 4 channels, got {s}")
    if n_rbf < 1:
        raise ValueError(f"n_rbf must be at least 1, got {n_rbf}")
    expected = {"xyz": (b, n, 3), "mask": (b, n), "v": (b, n, 3, f),
                "w": (n_rbf + 1, s, f), "gs": (b, n, f), "gv": (b, n, 3, f)}
    for name, t in args.items():
        if name in expected and tuple(t.shape) != expected[name]:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                             f"expected {expected[name]}")
    return b, n, s, f


def _launch_forward(xyz, mask, phi, v, w, cutoff, n_rbf):
    b, n, s, f = _check_cuda_inputs(
        {"xyz": xyz, "mask": mask, "phi": phi, "v": v, "w": w}, n_rbf)
    lib = build()
    device = xyz.device
    ds = torch.empty((b, n, f), dtype=torch.float32, device=device)
    dv = torch.empty((b, n, 3, f), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_message_fwd(
            xyz.data_ptr(), mask.data_ptr(), phi.data_ptr(), v.data_ptr(),
            w.data_ptr(), ds.data_ptr(), dv.data_ptr(),
            b, n, s, f, n_rbf + 1, float(cutoff), stream,
        )
    cuda_build.check(err, "fused_message")
    LAUNCHES["fused_message"] += 1
    LAUNCHES["fused_message_tc"] += lib.fused_message_route(b, n, s, n_rbf + 1)
    return ds, dv


def fused_message_vjp(
    xyz: torch.Tensor, mask: torch.Tensor, phi: torch.Tensor,
    v: torch.Tensor, w: torch.Tensor, gs: torch.Tensor, gv: torch.Tensor,
    cutoff: float, n_rbf: int,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The message's VJP: (d_phi (B,N,S,F), d_v (B,N,3,F), d_w (R+1,S,F)).

    CUDA tensors launch the backward kernel (counted in
    ``ops.LAUNCHES``); CPU tensors take
    ``message_vjp_reference``.
    """
    device = xyz.device
    if device.type == "cpu":
        return message_vjp_reference(xyz, mask, phi, v, w, gs, gv, cutoff, n_rbf)
    if device.type != "cuda":
        raise ValueError(f"fused_message_vjp runs on cpu or cuda, not {device}")
    b, n, s, f = _check_cuda_inputs(
        {"xyz": xyz, "mask": mask, "phi": phi, "v": v, "w": w, "gs": gs,
         "gv": gv}, n_rbf)
    r_aug = n_rbf + 1
    lib = build()
    d_phi = torch.empty((b, n, s, f), dtype=torch.float32, device=device)
    d_v = torch.empty((b, n, 3, f), dtype=torch.float32, device=device)
    # one partial d_w per (batch element, node tile of the grid)
    parts = lib.fused_message_bwd_partials(b, n, r_aug)
    dw_part = torch.empty((parts, r_aug, s, f), dtype=torch.float32, device=device)
    d_w = torch.empty((r_aug, s, f), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.fused_message_bwd(
            xyz.data_ptr(), mask.data_ptr(), phi.data_ptr(), v.data_ptr(),
            w.data_ptr(), gs.data_ptr(), gv.data_ptr(), d_phi.data_ptr(),
            d_v.data_ptr(), dw_part.data_ptr(), d_w.data_ptr(),
            b, n, s, f, r_aug, float(cutoff), stream,
        )
    cuda_build.check(err, "fused_message_vjp")
    LAUNCHES["fused_message_vjp"] += 1
    return d_phi, d_v, d_w


class _FusedMessage(torch.autograd.Function):
    """The forward kernel paired with its hand-derived backward kernel."""

    @staticmethod
    def forward(ctx, xyz, mask, phi, v, w, cutoff, n_rbf):
        ctx.save_for_backward(xyz, mask, phi, v, w)
        ctx.cutoff, ctx.n_rbf = cutoff, n_rbf
        if xyz.device.type == "cpu":
            return message_reference(xyz, mask, phi, v, w, cutoff, n_rbf)
        return _launch_forward(xyz, mask, phi, v, w, cutoff, n_rbf)

    @staticmethod
    def backward(ctx, gs, gv):
        # upstream cotangents may arrive as non-contiguous views, or as
        # materialised zeros for an output nothing reads
        d_phi, d_v, d_w = fused_message_vjp(
            *ctx.saved_tensors, gs.contiguous(), gv.contiguous(),
            ctx.cutoff, ctx.n_rbf)
        return None, None, d_phi, d_v, d_w, None, None


def fused_message(
    xyz: torch.Tensor, mask: torch.Tensor, phi: torch.Tensor,
    v: torch.Tensor, w: torch.Tensor, cutoff: float, n_rbf: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused factored message: (ds (B,N,F), dv (B,N,3,F)), differentiable in
    phi, v and w.

    phi: (B, N, S, F) pre-split per-node features (S=3 painn, S=4 cross);
    w: (R+1, S, F) filter weights (last basis row = bias channel). All
    inputs float32. CUDA tensors launch the kernel (counted in
    ``ops.LAUNCHES``, also as ``fused_message_tc`` on the tensor-core
    route); CPU tensors take ``message_reference``.
    """
    device = xyz.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_message runs on cpu or cuda, not {device}")
    return _FusedMessage.apply(xyz, mask, phi, v, w, cutoff, n_rbf)

