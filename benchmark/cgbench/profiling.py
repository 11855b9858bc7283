"""The yardstick's arithmetic: the table of peaks, the kernels' least bytes
and FLOPs, and the reduction of a ``torch.profiler`` window to device and
host intervals.

``kernel_cost`` and ``bound`` are a frozen copy of the port's
``utils/profiling.py`` at commit add70c80 (hand-counted, reviewed with the
kernels' redesign); ``Trace`` follows that file's ``device_profile`` (busy
time as the union of device intervals, items by name) and also counts
``cudaGraphLaunch``, the one launch a captured step makes.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from dataclasses import dataclass
from typing import List, Tuple

# published peaks of one H100 SXM (NVIDIA's data sheet, dense, 700 W)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
BF16_FLOP_PER_S = 989e12

# host calls that put work on the device: kernels one at a time, or a graph
LAUNCH_CALLS = frozenset({"cudaLaunchKernel", "cuLaunchKernel", "cuLaunchKernelEx",
                          "cudaLaunchKernelExC", "cudaGraphLaunch", "cuGraphLaunch"})


def kernel_cost(kind: str, b: int, n: int, s: int, f: int, n_rbf: int, pairs: int) -> tuple:
    """(bytes, FLOPs) that one call of a kernel's function needs: each f32
    input read once and each output written once, and the least arithmetic
    over ``pairs``, the ordered pairs with adj * env != 0 summed over the
    batch; FMA = 2 FLOPs (the port's ``utils/profiling.py::kernel_cost``,
    whose docstring gives the count per pair and per node)."""
    ra, nodes = n_rbf + 1, b * n
    geometry = nodes * 4
    filters, d_w = 2 * s * ra, s + 2 * s * ra
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


def bound(n_bytes: int, flops: int) -> float:
    """The least seconds one H100 could take: the larger of bytes over the
    HBM rate and FLOPs over the FP32 rate."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOP_PER_S)


@dataclass
class Trace:
    """One profiled window: device intervals (name, start s, end s), host
    intervals, and the window's wall seconds and steps."""
    kernels: List[Tuple[str, float, float]]
    host: List[Tuple[str, float, float]]
    wall_s: float
    steps: int

    @classmethod
    def from_profiler(cls, prof, wall_s: float, steps: int) -> "Trace":
        from torch.autograd import DeviceType

        kernels, host = [], []
        for e in prof.profiler.kineto_results.events():
            start = e.start_ns() * 1e-9
            span = (e.name(), start, start + e.duration_ns() * 1e-9)
            (kernels if e.device_type() == DeviceType.CUDA else host).append(span)
        return cls(kernels, host, wall_s, steps)

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of the
        device intervals."""
        total, cur_s, cur_e = 0.0, None, None
        for s, e in sorted((s, e) for _, s, e in self.kernels):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        return total + (cur_e - cur_s if cur_e is not None else 0.0)

    def launches(self) -> int:
        return sum(1 for name, _, _ in self.host if name in LAUNCH_CALLS)

    def seconds_where(self, pred) -> Tuple[float, int]:
        """(device seconds, count) of the kernels whose name satisfies ``pred``."""
        hits = [(e - s) for name, s, e in self.kernels if pred(name)]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10) -> List[list]:
        by_name = defaultdict(float)
        for name, s, e in self.kernels:
            by_name[name[:120]] += e - s
        return [[n, t] for n, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> List[list]:
        """The device's idle gaps summed by what the host was doing: the
        host interval that started last before each gap's middle and
        covers it."""
        spans = sorted((s, e) for _, s, e in self.kernels)
        gaps, cur_e = [], None
        for s, e in spans:
            if cur_e is not None and s > cur_e:
                gaps.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        by_label = defaultdict(float)
        for a, b in gaps:
            mid = 0.5 * (a + b)
            i = bisect.bisect_right(starts, mid) - 1
            label = "(no host call)"
            while i >= 0:
                name, s, e = host[i]
                if e >= mid:
                    label = name[:120]
                    break
                i -= 1
                if mid - s > 1.0:
                    break
            by_label[label] += b - a
        return [[n, t] for n, t in sorted(by_label.items(), key=lambda kv: -kv[1])[:k]]
