"""The tensor-core forward's precision contract, on the CPU.

``csrc/fused_message.cu``'s tensor-core forward (kernel 1 at S 3, R+1 <=
16 and N >= kTcMinN) runs the fold of the filter over the basis, filt_c =
sum_r K[r] w[r, c], as 3xTF32 MMAs: each f32 operand split into a TF32 high
part and a TF32 low part, the products lo x hi, hi x lo and hi x hi
accumulated in f32, per step of kTcK basis functions (one m16n8k8 MMA). The
message itself stays on the FMA pipes in f32. Here the fold is emulated in
torch, TF32 rounding as ``cvt.rna.tf32.f32`` rounds (10 mantissa bits, ties
away from zero), at chignolin's encoder shape (N 209, every pair inside the
cutoff) at its R+1 of 11 and at the largest templated R+1, 16: the split
stays within 1e-4 of max|ref| of the plain version in float64, the kernels'
gate (within a tenth of it), and single-pass TF32 (hi x hi alone) does not.
An MMA's own sum of its products is taken exactly. The emulation holds the
design and its rounding, never the CUDA code: tests/test_torch_gpu.py holds
the kernel on the card.
"""
import re

import pytest
import torch

from coarsegrainingvae_tpu_torch.ops import cuda_build
from coarsegrainingvae_tpu_torch.ops.fused_message import message_reference
from coarsegrainingvae_tpu_torch.ops.geometry import pair_filter_basis

B, N, F, CUTOFF = 2, 209, 32, 25.0
GATE = 1e-4


def _fold_step() -> int:
    """kTcK of the kernel: the basis functions of one fold MMA."""
    text = (cuda_build.CSRC / "fused_message.cu").read_text()
    return int(re.search(r"constexpr int kTcK = (\d+);", text).group(1))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """x (f32) rounded to TF32: 10 mantissa bits, ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


def _terms(a: torch.Tensor, b: torch.Tensor, passes: int):
    """The operand pairs of one product: (hi, hi) alone, or the 3xTF32
    split's (lo, hi), (hi, lo), (hi, hi), each in float64."""
    ah, bh = tf32(a), tf32(b)
    if passes == 1:
        return [(ah.double(), bh.double())]
    al, bl = tf32(a - ah), tf32(b - bh)
    return [(al.double(), bh.double()), (ah.double(), bl.double()), (ah.double(), bh.double())]


def fold(k: torch.Tensor, w: torch.Tensor, passes: int) -> torch.Tensor:
    """filt[b, i, j, c, f] = sum_r K[b, i, j, r] w[r, c, f], accumulated in
    f32 per step of kTcK basis functions and per product."""
    acc = torch.zeros(*k.shape[:3], *w.shape[1:])
    step = _fold_step()
    for r0 in range(0, k.shape[-1], step):
        for x, y in _terms(k[..., r0:r0 + step], w[r0:r0 + step], passes):
            acc = (acc.double() + torch.einsum("bijr,rcf->bijcf", x, y)).float()
    return acc


@pytest.fixture(scope="module", params=[10, 15], ids=["n_rbf10", "n_rbf15"])
def problem(request):
    """Chignolin's encoder shape with every pair live: the inputs, the
    geometry in f32 as the kernel builds it, and the plain forward in
    float64."""
    n_rbf = request.param
    g = torch.Generator().manual_seed(23)
    xyz = torch.rand(B, N, 3, generator=g) * 12.0      # a 12-A box inside the 25-A cutoff
    mask = torch.ones(B, N)
    phi = torch.randn(B, N, 3, F, generator=g)
    v = torch.randn(B, N, 3, F, generator=g)
    w = torch.randn(n_rbf + 1, 3, F, generator=g) * 0.3
    unit, adj, k = pair_filter_basis(xyz, mask, CUTOFF, n_rbf)
    assert int(adj.sum()) == B * N * (N - 1)
    ref = message_reference(*(t.double() for t in (xyz, mask, phi, v, w)), CUTOFF, n_rbf)
    return dict(unit=unit, k=k, phi=phi, v=v, w=w, ref=ref)


def _forward_errors(pb: dict, passes: int) -> dict:
    """max|err| / max|ref| of ds and dv: the fold emulated, the message in
    f32."""
    filt = fold(pb["k"], pb["w"], passes)
    phi, v = pb["phi"], pb["v"]
    ds = torch.einsum("bijf,bjf->bif", filt[:, :, :, 1], phi[:, :, 1])
    dv = (torch.einsum("bijf,bjf,bjdf->bidf", filt[:, :, :, 0], phi[:, :, 0], v)
          + torch.einsum("bijf,bjf,bijd->bidf", filt[:, :, :, 2], phi[:, :, 2], pb["unit"]))
    return {name: float((got.double() - ref).abs().max() / ref.abs().max())
            for name, got, ref in zip(("ds", "dv"), (ds, dv), pb["ref"])}


def test_three_tf32_passes_stay_inside_the_gate(problem):
    errs = _forward_errors(problem, 3)
    assert max(errs.values()) <= GATE / 10, errs


def test_single_pass_tf32_leaves_the_gate(problem):
    errs = _forward_errors(problem, 1)
    assert min(errs.values()) > GATE, errs
