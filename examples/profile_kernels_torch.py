"""Kernel shape table on the PyTorch port: the hand-written CUDA kernels
against their plain PyTorch versions, forward plus backward, at the shapes of
``examples/profile_kernels.py``.

- pseudo message (kernels 3 and 4, ``ops/fused_pseudo.py``): M = 3
  (dipeptide flagship), 6 (chignolin), 100 and 300 (PCN-scale CG graphs;
  the kernels' chunked path, M > 6)
- factored message (kernels 1 and 2, ``ops/fused_message.py``, S = 4): N =
  27 (dipeptide atoms), 209 (chignolin atoms), 500

Each row runs the original's step, ``loss = sum out^2`` and then ``loss +
sum d_phi + sum d_w``, on the original's arrays (``np.random.default_rng(0)``
in its draw order) through three paths: (a) the port's kernels through
their ``autograd.Function``; (b) the plain version, the plain forward paired
with the plain VJP in an ``autograd.Function``, the counterpart of the
original's jitted ``*_reference``; (c) with ``--compile``, (b) under
``torch.compile``, a yardstick only (the model never runs it). On the card
each path is timed as replays of a CUDA graph of ``--steps`` steps
(``utils.profiling.graph_ms``), so the host's launch cost stays out; on the
CPU (``--device cpu``, where (a) is the plain version itself) by the host
clock. Every row checks the kernels' outputs and both gradients against (b)
at 1e-4 of max|ref| and raises on a miss (and reports (c)'s error beside). The original skips the shapes
whose blocks overflow a TPU core's VMEM; here every row runs.

Prints one JSON line per (kernel, shape, path) with the original's labels:
``*_xla_*`` the plain version (b), with (c) beside it, and ``*_pallas_*`` the
kernels (a), with the plain and compiled times, the roofline bound of the
two kernels' functions (``utils.profiling.kernel_cost``, H100 peaks), the
share of it the kernels reach and the worst relative errors.

Usage:  python examples/profile_kernels_torch.py [--steps 30] [--f 600]
            [--compile] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

# (B, M) of the pseudo rows and (B, N) of the message rows, as in the original
PSEUDO_SHAPES = ((32, 3), (16, 6), (4, 100), (1, 300))
MESSAGE_SHAPES = ((32, 27), (8, 209), (2, 500))
N_RBF = 8
CUTOFF = {"pseudo": 21.0, "message": 9.5}
# every output and gradient of the kernels against the plain version, as a
# fraction of max|ref| (f32, another summation order)
RTOL = 1e-4
REPLAYS = 2


def pseudo_inputs(b: int, m: int, f: int, n_rbf: int = N_RBF) -> dict:
    """The original's pseudo arrays (profile_kernels.py:59-67), in its draw
    order."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(b, m, 3)).astype(np.float32) * 3
    mask = np.ones((b, m), np.float32)
    phi = rng.normal(size=(b, m, 9, f)).astype(np.float32)
    s = rng.normal(size=(b, m, f)).astype(np.float32)
    sbar = np.ones_like(s)
    v = rng.normal(size=(b, m, 3, f)).astype(np.float32)
    vbar = np.zeros_like(v)
    w = rng.normal(size=(n_rbf + 1, 9, f)).astype(np.float32) * 0.1
    return dict(xyz=xyz, mask=mask, phi=phi, s=s, sbar=sbar, v=v, vbar=vbar, w=w)


def message_inputs(b: int, n: int, f: int, n_rbf: int = N_RBF) -> dict:
    """The original's message arrays (profile_kernels.py:108-113), in its
    draw order."""
    rng = np.random.default_rng(0)
    xyz = rng.normal(size=(b, n, 3)).astype(np.float32) * 4
    mask = np.ones((b, n), np.float32)
    phi = rng.normal(size=(b, n, 4, f)).astype(np.float32)
    v = rng.normal(size=(b, n, 3, f)).astype(np.float32)
    w = rng.normal(size=(n_rbf + 1, 4, f)).astype(np.float32) * 0.1
    return dict(xyz=xyz, mask=mask, phi=phi, v=v, w=w)


class PlainMessage(torch.autograd.Function):
    """``message_reference`` paired with ``message_vjp_reference``: kernels
    1 and 2's plain version, on any device."""

    @staticmethod
    def forward(ctx, xyz, mask, phi, v, w, cutoff, n_rbf):
        from coarsegrainingvae_tpu_torch.ops.fused_message import message_reference

        ctx.save_for_backward(xyz, mask, phi, v, w)
        ctx.cutoff, ctx.n_rbf = cutoff, n_rbf
        return message_reference(xyz, mask, phi, v, w, cutoff, n_rbf)

    @staticmethod
    def backward(ctx, gs, gv):
        from coarsegrainingvae_tpu_torch.ops.fused_message import message_vjp_reference

        d_phi, d_v, d_w = message_vjp_reference(*ctx.saved_tensors, gs.contiguous(),
                                                gv.contiguous(), ctx.cutoff, ctx.n_rbf)
        return None, None, d_phi, d_v, d_w, None, None


class PlainPseudo(torch.autograd.Function):
    """``pseudo_reference`` paired with ``pseudo_vjp_reference``: kernels 3
    and 4's plain version, on any device."""

    @staticmethod
    def forward(ctx, xyz, mask, phi, s, sbar, v, vbar, w, cutoff, n_rbf):
        from coarsegrainingvae_tpu_torch.ops.fused_pseudo import pseudo_reference

        ctx.save_for_backward(xyz, mask, phi, s, sbar, v, vbar, w)
        ctx.cutoff, ctx.n_rbf = cutoff, n_rbf
        return pseudo_reference(xyz, mask, phi, s, sbar, v, vbar, w, cutoff, n_rbf)

    @staticmethod
    def backward(ctx, gs, gsb, gv, gvb):
        from coarsegrainingvae_tpu_torch.ops.fused_pseudo import pseudo_vjp_reference

        grads = pseudo_vjp_reference(*ctx.saved_tensors, gs.contiguous(), gsb.contiguous(),
                                     gv.contiguous(), gvb.contiguous(), ctx.cutoff, ctx.n_rbf)
        return (None, None) + tuple(grads) + (None, None)


ORDER = {"pseudo": ("xyz", "mask", "phi", "s", "sbar", "v", "vbar", "w"),
         "message": ("xyz", "mask", "phi", "v", "w")}


def paths(kind: str, compile_plain: bool = False) -> dict:
    """{path: fn(*inputs, cutoff, n_rbf) -> outputs}: "kernel" (a), "plain"
    (b) and, with ``compile_plain``, "compiled" (c)."""
    from coarsegrainingvae_tpu_torch.ops.fused_message import fused_message
    from coarsegrainingvae_tpu_torch.ops.fused_pseudo import fused_pseudo_message

    kernel, plain = ((fused_pseudo_message, PlainPseudo.apply) if kind == "pseudo"
                     else (fused_message, PlainMessage.apply))
    out = {"kernel": kernel, "plain": plain}
    if compile_plain:
        torch._dynamo.reset()          # a fresh compile per row: no recompile limit
        out["compiled"] = torch.compile(plain, dynamic=False)
    return out


def to_tensors(arrays: dict, device) -> dict:
    """The arrays on ``device``; phi and w are leaves that take gradients."""
    t = {k: torch.from_numpy(a).to(device) for k, a in arrays.items()}
    for k in ("phi", "w"):
        t[k].requires_grad_(True)
    return t


def step(kind: str, fn, t: dict, cutoff: float, n_rbf: int = N_RBF) -> tuple:
    """The original's step (profile_kernels.py:69-78, :115-124) through
    ``fn``: (loss + sum d_phi + sum d_w, the outputs, (d_phi, d_w))."""
    outs = fn(*(t[k] for k in ORDER[kind]), cutoff, n_rbf)
    loss = sum(torch.sum(o * o) for o in outs)
    gp, gw = torch.autograd.grad(loss, (t["phi"], t["w"]))
    return loss.detach() + torch.sum(gp) + torch.sum(gw), outs, (gp, gw)


def check(kind: str, fns: dict, t: dict, cutoff: float, label: str) -> dict:
    """{path: max|path - plain| / max|plain|} over the outputs and both
    gradients of each path but the plain one, each path once; raises when
    the kernels' passes RTOL (the compiled yardstick's is only reported)."""
    from coarsegrainingvae_tpu_torch.utils.profiling import rel_err

    def flat(fn):
        _, outs, grads = step(kind, fn, t, cutoff)
        return [x.detach() for x in (*outs, *grads)]

    ref = flat(fns["plain"])
    rel = {name: rel_err(flat(fn), ref)[0] for name, fn in fns.items() if name != "plain"}
    if not rel["kernel"] <= RTOL:
        raise RuntimeError(f"{label}: the kernels miss their plain version by "
                           f"{rel['kernel']:.3e} of max|ref| (> {RTOL})")
    return rel


def timed_ms(fn, steps: int, device: torch.device, counters=()) -> float:
    """ms per call: CUDA-graph replays on the card, the host clock on the
    CPU."""
    if device.type == "cuda":
        from coarsegrainingvae_tpu_torch.utils.profiling import graph_ms

        return graph_ms(fn, steps, REPLAYS, counters)
    fn()
    t0 = time.perf_counter()
    for _ in range(steps):
        fn()
    return (time.perf_counter() - t0) / steps * 1e3


def step_bound(kind: str, t: dict, cutoff: float, n_rbf: int = N_RBF) -> tuple:
    """(ms, "bytes" or "operations"): the least time an H100 could take for
    the two kernels' functions of one step (forward and VJP, each bound by
    the slower of its bytes and its FLOPs; the pairs this data needs), and
    what bounds the larger of the two."""
    from coarsegrainingvae_tpu_torch.ops.geometry import pair_filter_basis
    from coarsegrainingvae_tpu_torch.utils.profiling import bound, kernel_cost

    b, n, s, f = t["phi"].shape
    with torch.no_grad():
        pairs = int(pair_filter_basis(t["xyz"], t["mask"], cutoff, n_rbf)[1].sum().item())
    parts = [bound(*kernel_cost(k, b, n, s, f, n_rbf, pairs)) for k in (kind, kind + "_vjp")]
    return sum(p[0] for p in parts), max(parts)[1]


def run_row(kind: str, b: int, n: int, f: int, steps: int, device: torch.device,
            compile_plain: bool = False) -> list:
    """The two JSON rows of one (kernel, shape): the plain version's
    (``*_xla_*``) and the kernels' (``*_pallas_*``)."""
    from coarsegrainingvae_tpu_torch.ops import kernel_counters

    size = "M" if kind == "pseudo" else "N"
    label = f"{kind}_{{}}_B{b}_{size}{n}_F{f}"
    cutoff = CUTOFF[kind]
    arrays = pseudo_inputs(b, n, f) if kind == "pseudo" else message_inputs(b, n, f)
    t = to_tensors(arrays, device)
    fns = paths(kind, compile_plain)
    rel = check(kind, fns, t, cutoff, label.format("pallas"))
    counters = kernel_counters()
    ms = {name: timed_ms(lambda fn=fn: step(kind, fn, t, cutoff)[0], steps, device,
                         counters if name == "kernel" else ())
          for name, fn in fns.items()}
    compiled = ms.get("compiled")
    plain_row = {"label": label.format("xla"), "ms_per_step": ms["plain"],
                 "compiled_ms": compiled}
    kernel_row = {"label": label.format("pallas"), "ms_per_step": ms["kernel"],
                  "plain_ms": ms["plain"], "compiled_ms": compiled,
                  "max_rel_err": rel["kernel"], "compiled_rel_err": rel.get("compiled")}
    if device.type == "cuda":
        bound_ms, bound_by = step_bound(kind, t, cutoff)
        kernel_row.update(bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / ms["kernel"])
    else:                      # a bound of the card is no yardstick for the CPU
        kernel_row.update(bound_ms=None, bound_by=None, share=None)
    del t
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return [plain_row, kernel_row]


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=30)
    p.add_argument("--f", type=int, default=600)
    p.add_argument("--compile", action="store_true",
                   help="also time the plain version under torch.compile")
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    device = torch.device(a.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    head = {"backend": device.type}
    if device.type == "cuda":
        head["device"] = torch.cuda.get_device_name(device)
    print(json.dumps(head), flush=True)
    rows = []
    for kind, shapes in (("pseudo", PSEUDO_SHAPES), ("message", MESSAGE_SHAPES)):
        for b, n in shapes:
            for row in run_row(kind, b, n, a.f, a.steps, device, a.compile):
                print(json.dumps(row), flush=True)
                rows.append(row)
    return rows


if __name__ == "__main__":
    main()
