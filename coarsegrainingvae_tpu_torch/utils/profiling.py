"""Profiling and timing in torch terms (port of
``coarsegrainingvae_tpu.utils.profiling``).

``trace`` records a ``torch.profiler`` window (CPU and, with a card, CUDA
activity) and writes it as a Chrome trace; ``StepTimer`` keeps per-step
wall-clock statistics, its ``tick`` synchronising the device first (the JAX
package's caller blocks on each step); ``time_compile`` sets a callable's
first call (lazy nvcc builds, CUDA-graph capture, caches) against a steady
call; ``save_runtime`` writes a wall-clock figure as JSON.

On the card: ``graph_ms`` times a callable as replays of a CUDA graph (the
host's launch cost left out), ``rel_err`` holds outputs against a reference
as max|err| / max|ref|, and ``kernel_cost`` / ``bound`` give the least
bytes and FLOPs one call of a kernel's function needs and the least time
an H100 could take for them (the roofline bound).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str, name: str = "trace.json"):
    """Profile the block and write ``logdir/name``, a Chrome trace (open it
    in Perfetto or chrome://tracing). Usage: ``with trace("./tb"): run()``.
    Yields the profiler (``key_averages()`` for tables)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        try:
            yield prof
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(logdir, name))


class StepTimer:
    """Wall-clock per-step statistics with warm-up exclusion.

    Call ``start()`` once and ``tick()`` after each step; ``tick`` waits for
    the card first, so a step's time is its device time plus the host's.
    ``summary()`` reports mean/p50/p95 step time and throughput.
    """

    def __init__(self, warmup: int = 3):
        self.warmup = warmup
        self._t: List[float] = []
        self._last: Optional[float] = None

    def start(self) -> None:
        _sync()
        self._last = time.perf_counter()

    def tick(self) -> None:
        _sync()
        now = time.perf_counter()
        if self._last is not None:
            self._t.append(now - self._last)
        self._last = now

    def summary(self, items_per_step: int = 1) -> Dict[str, float]:
        t = np.asarray(self._t[self.warmup:])
        if t.size == 0:
            return {}
        return {
            "steps": int(t.size),
            "mean_s": float(t.mean()),
            "p50_s": float(np.percentile(t, 50)),
            "p95_s": float(np.percentile(t, 95)),
            "items_per_s": float(items_per_step / t.mean()),
        }


def time_compile(fn, *args) -> Dict[str, float]:
    """(first call, steady call) of ``fn(*args)``, each ending in a device
    sync: the first pays for lazy kernel builds, CUDA-graph capture and
    caches, whose cost is approximately their difference."""
    _sync()
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    fn(*args)
    _sync()
    steady = time.perf_counter() - t0
    return {"first_call_s": first, "steady_s": steady,
            "compile_s_approx": max(first - steady, 0.0)}


def save_runtime(seconds: float, path: str) -> None:
    """Write a wall-clock figure as JSON ({"wall_clock_s": seconds})."""
    with open(path, "w") as f:
        json.dump({"wall_clock_s": seconds}, f)


class Replays:
    """``per_graph`` calls of ``fn`` captured in one CUDA graph, after three
    warm-up calls on a side stream (lazy builds, autograd's first pass,
    ``torch.compile``). ``fn`` may run autograd; it draws random numbers only
    from the default generator. ``counters`` are kernel wrappers with a
    ``launches`` count: the warm-up calls launch their kernels and count
    them; the capture records one graph's launches as ``per_replay`` and
    puts each count back, since it launches nothing; ``replay`` adds
    ``per_replay`` for every replay, which launches them."""

    def __init__(self, fn, per_graph: int = 1, counters: Sequence = ()):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for _ in range(3):
                fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        self.counters = tuple(counters)
        before = [c.launches for c in self.counters]
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            for _ in range(per_graph):
                fn()
        self.per_replay = [c.launches - n for c, n in zip(self.counters, before)]
        for c, n in zip(self.counters, before):
            c.launches = n

    def replay(self, n: int = 1) -> None:
        for _ in range(n):
            self.graph.replay()
        for c, k in zip(self.counters, self.per_replay):
            c.launches += k * n

    def reset(self) -> None:
        self.graph.reset()


def graph_ms(fn, per_graph: int = 20, replays: int = 5, counters: Sequence = ()) -> float:
    """ms per call of ``fn``: ``per_graph`` calls captured in one CUDA graph
    (``Replays``), replayed ``replays`` times between two CUDA events, so
    the host's launch cost stays out of the time (device time, also at the
    small shapes)."""
    run = Replays(fn, per_graph, counters)
    run.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    run.replay(replays)
    end.record()
    torch.cuda.synchronize()
    run.reset()
    return start.elapsed_time(end) / (per_graph * replays)


def rel_err(out, ref) -> tuple:
    """(max over the pairs of max|out - ref| / max|ref|, the largest
    max|out - ref|) of two sequences of tensors; raises on a shape that
    differs or a value that is not finite."""
    worst_rel, worst_abs = 0.0, 0.0
    for a, b in zip(out, ref):
        if a.shape != b.shape or not torch.isfinite(a).all():
            raise RuntimeError(f"kernel output shape {tuple(a.shape)} vs {tuple(b.shape)} or not finite")
        err = (a - b).abs().max().item()
        worst_abs = max(worst_abs, err)
        worst_rel = max(worst_rel, err / max(b.abs().max().item(), 1e-30))
    return worst_rel, worst_abs


# published peaks of one H100 SXM (NVIDIA's data sheet, 700 W): HBM bytes/s
# and FP32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S, FP32_FLOP_PER_S = 3.35e12, 67e12


def kernel_cost(kind: str, b: int, n: int, s: int, f: int, n_rbf: int, pairs: int) -> tuple:
    """(bytes, FLOPs) that one call of a kernel's function needs, whichever
    kernel computes it: each f32 input read once and each output written
    once (scratch not counted), and the least arithmetic over ``pairs``, the
    ordered pairs with adj * env != 0 summed over the batch (the others
    contribute nothing; adj and K are symmetric, so ``pairs`` is even);
    FMA = 2 FLOPs. K[p,q] = K[q,p], so per unordered pair and feature the
    filter filt_c = K.w_c is folded once for both directions (S (R+1) FMAs),
    and a sum over pairs of K[p,q,r] x_c(p,q), as in d_w, is one (R+1)-long
    FMA chain on x_c(p,q) + x_c(q,p) (S adds and S (R+1) FMAs).

    message      per unordered pair the filters; per ordered pair 1 + 3 (S - 1)
                 product FMAs and S - 1 multiplies; per node (S = 4) the
                 receiver cross, 12.
    message_vjp  per unordered pair the filters and d_w; per ordered pair S
                 multiplies phi t and the cotangent terms, 22 (+ 19 when
                 S = 4); per node phi_0 a_0, 3 (+ 30 when S = 4).
    pseudo       (S = 9 channels) per unordered pair the filters; per ordered
                 pair 9 multiplies and 55 aggregate FLOPs; per node 57.
    pseudo_vjp   per unordered pair the filters and d_w; per ordered pair 161
                 (9 multiplies phi dG, the dG terms 40, d_phi 18, the sender
                 side g Gamma 44, the forward's sums 43, the dsbar path 7);
                 per node 88 (s gs 1, the Gammas 33, d_s 1, d_sbar 11, the
                 three receiver crosses 36, gsb t 6).
    """
    ra, nodes = n_rbf + 1, b * n
    geometry = nodes * 4                        # xyz and mask
    filters, d_w = 2 * s * ra, s + 2 * s * ra   # per unordered pair
    if kind == "message":
        node_io, w_io = (s + 3) + 4, ra * s * f
        per_unordered, per_pair = filters, 2 + 7 * (s - 1)
        per_node = 12 if s == 4 else 0
    elif kind == "message_vjp":
        node_io, w_io = (s + 3 + 4) + (s + 3), 2 * ra * s * f
        per_unordered, per_pair = filters + d_w, s + 22 + (19 if s == 4 else 0)
        per_node = 3 + (30 if s == 4 else 0)
    elif kind == "pseudo":
        node_io, w_io = (9 + 2 + 6) + 8, ra * 9 * f
        per_unordered, per_pair, per_node = filters, 64, 57
    elif kind == "pseudo_vjp":
        node_io, w_io = (9 + 2 + 6 + 8) + (9 + 8), 2 * ra * 9 * f
        per_unordered, per_pair, per_node = filters + d_w, 161, 88
    else:
        raise ValueError(f"unknown kernel {kind!r}")
    n_bytes = 4 * (geometry + nodes * node_io * f + w_io)
    return n_bytes, f * (pairs // 2 * per_unordered + pairs * per_pair + nodes * per_node)


def bound(n_bytes: int, flops: int) -> tuple:
    """(ms, "bytes" or "operations", "HBM" or "FP32"): the least time one
    H100 could take, the larger of bytes over the HBM rate and FLOPs over
    the FP32 rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    return (t_bytes, "bytes", "HBM") if t_bytes >= t_ops else (t_ops, "operations", "FP32")


def device_profile(prof, wall_ms: float, steps: int) -> dict:
    """Device busy time (union of kernel intervals), the top device items
    and the device launches per step of a torch.profiler window."""
    from torch.autograd import DeviceType

    events = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    busy_us, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy_us += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy_us += cur_e - cur_s
    by_name = defaultdict(lambda: [0.0, 0])
    for e in events:
        by_name[e.name][0] += e.time_range.elapsed_us()
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    host_launches = sum(1 for e in prof.events()
                        if e.name in ("cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx"))
    return {"busy_ms": busy_us / 1e3, "busy_share": busy_us / 1e3 / wall_ms,
            "device_events_per_step": len(events) / steps,
            "host_launch_calls_per_step": host_launches / steps,
            "top": [(name[:70], us / 1e3 / steps, n // steps) for name, (us, n) in top]}
