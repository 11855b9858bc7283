"""The captured train step's phases in a traced window, read from the
program's own boundaries: the one-thread kernels ``cgvae_mark_<boundary>``
that the port's ``utils/tracing.py`` places in the step (its ``MARKS``, in
order: step, forward, backward, exchange on several ranks, optimizer,
bookkeeping, end). A phase runs from the start of its mark to the start of
the next mark, so the phases tile each step from the start of
``cgvae_mark_step`` to the end of ``cgvae_mark_end``.

The mark names come from the port, so nothing is spelled twice; a program
that has no marks (no ``utils/tracing.py``, or none in the trace) gives
None.
"""
from __future__ import annotations

import bisect
from typing import Iterable, List, Optional, Tuple


def mark_kernels() -> Optional[dict]:
    """{kernel name: mark} of the port's step marks, or None where the
    port has none."""
    try:
        from coarsegrainingvae_tpu_torch.utils import tracing
    except ImportError:
        return None
    return {tracing.kernel_name(m): m for m in tracing.MARKS}


def marks(trace) -> List[Tuple[str, float, float]]:
    """(mark, start s, end s) of every mark kernel in the trace, by start."""
    names = mark_kernels()
    if not names:
        return []
    return sorted(((names[n], s, e) for n, s, e in trace.kernels if n in names),
                  key=lambda m: m[1])


def phase_ms(trace, start: str, ends: Iterable[str]) -> Optional[float]:
    """Mean ms per step from the start of each ``start`` mark to the start
    of the next mark named in ``ends``; None without such pairs."""
    ends = set(ends)
    found = marks(trace)
    total, n = 0.0, 0
    for i, (name, s, _) in enumerate(found):
        if name != start:
            continue
        nxt = next((t for m, t, _ in found[i + 1:] if m in ends), None)
        if nxt is not None:
            total += nxt - s
            n += 1
    return 1e3 * total / n if n else None


def _union(intervals: Iterable[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def steps(trace) -> List[Tuple[float, float]]:
    """Each step's interval: the start of a ``step`` mark to the end of
    the next ``end`` mark."""
    found = marks(trace)
    out = []
    for i, (name, s, _) in enumerate(found):
        if name == "step":
            end = next((e for m, _, e in found[i + 1:] if m == "end"), None)
            if end is not None:
                out.append((s, end))
    return out


def idle_ms(trace, windows: List[Tuple[float, float]]) -> Optional[float]:
    """Mean ms per window in which no device operation ran: each window's
    length less the union of the device intervals inside it."""
    if not windows:
        return None
    busy = _union((s, e) for _, s, e in trace.kernels)
    starts = [s for s, _ in busy]
    idle = 0.0
    for a, b in windows:
        covered = 0.0
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        while i < len(busy) and busy[i][0] < b:
            covered += max(0.0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        idle += (b - a) - covered
    return 1e3 * idle / len(windows)
