"""The parts of the captured train step's forward phase in a traced window,
read from the program's own marks inside that phase: the one-thread kernels
``cgvae_mark_<boundary>`` of the port's ``utils/tracing.py::FORWARD_MARKS``
(``decode`` before the dense model's decoder, ``loss`` before
``vae_loss``). A part runs from the start of its mark to the start of the
next mark of the step.

The mark names come from the port; a program without such marks (no
``FORWARD_MARKS``, or none of them in the trace) gives None.
"""
from __future__ import annotations

from typing import Optional


def part_ms(trace, start: str, end: str) -> Optional[float]:
    """Mean ms per step from the start of each ``start`` mark to the start
    of the next ``end`` mark; None without such pairs."""
    try:
        from coarsegrainingvae_tpu_torch.utils import tracing
    except ImportError:
        return None
    inner = getattr(tracing, "FORWARD_MARKS", ())
    if start not in inner:
        return None
    names = {tracing.kernel_name(m): m for m in (*tracing.MARKS, *inner)}
    found = sorted(((names[n], s) for n, s, _ in trace.kernels if n in names),
                   key=lambda m: m[1])
    total, n = 0.0, 0
    for i, (name, s) in enumerate(found):
        if name != start:
            continue
        nxt = next((t for m, t in found[i + 1:] if m == end), None)
        if nxt is not None:
            total += nxt - s
            n += 1
    return 1e3 * total / n if n else None
