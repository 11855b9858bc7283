"""Kernels and the plain torch operations around them.

``LAUNCHES`` counts the hand-written kernels' launches by name, where each
wrapper launches: kernels 1-4 (``fused_message``, ``fused_message_vjp``,
``fused_pseudo_message``, ``fused_pseudo_vjp``), the fused optimizer step
(``fused_adam``) and its norm alone (``fused_global_norm``), and kernel
1's launches on the tensor-core route (``fused_message_tc``, also counted
in ``fused_message``). CPU tensors run the plain versions and count
nothing. ``GraphLaunches`` keeps the counts of a CUDA graph: its capture
launches nothing and its replays launch what it captured.
"""
from typing import Callable, Dict

KERNELS = ("fused_message", "fused_message_vjp", "fused_pseudo_message", "fused_pseudo_vjp",
           "fused_adam", "fused_global_norm", "fused_message_tc")

LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    """Every count back to 0."""
    LAUNCHES.update(dict.fromkeys(KERNELS, 0))


def read_launches() -> Dict[str, int]:
    """A copy of every count, by name."""
    return dict(LAUNCHES)


class GraphLaunches:
    """The launches of one CUDA graph. ``warm_up()`` then ``capture()`` run
    with the counts left as they were before: a capture launches nothing,
    and the caller undoes the warm-up's work. ``per_replay`` is what
    ``capture()`` counted, the launches of one replay; ``replayed(n)`` adds
    n replays' to the counts."""

    def __init__(self, capture: Callable[[], None], warm_up: Callable[[], None] = lambda: None):
        before = read_launches()
        warm_up()
        start = read_launches()
        capture()
        self.per_replay = {k: LAUNCHES[k] - start[k] for k in KERNELS}
        LAUNCHES.update(before)

    def replayed(self, n: int = 1) -> None:
        for k, v in self.per_replay.items():
            LAUNCHES[k] += v * n
