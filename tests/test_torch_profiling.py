"""``utils.profiling``'s CUDA-graph timing counts only the kernel launches
that ran: the warm-up calls and every replay, never the capture.

On the CPU, torch.cuda's streams, graphs and events are replaced by
stand-ins that keep CUDA's semantics for the count: a capture runs the
Python body (the wrappers count there) and launches nothing, a replay
launches what was captured. tests/test_torch_gpu.py holds the same count
with the real kernels on the card.
"""
import contextlib
import types

import pytest
import torch

from coarsegrainingvae_tpu_torch.utils import profiling


class _Graph:
    def replay(self):
        pass

    def reset(self):
        pass


class _Event:
    def __init__(self, enable_timing=False):
        pass

    def record(self):
        pass

    def elapsed_time(self, end):
        return 1.0


@pytest.fixture
def fake_cuda(monkeypatch):
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    for name, value in (("Stream", lambda: stream), ("current_stream", lambda: stream),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("synchronize", lambda: None), ("CUDAGraph", _Graph),
                        ("graph", lambda g: contextlib.nullcontext()), ("Event", _Event)):
        monkeypatch.setattr(torch.cuda, name, value)


def _kernel():
    def kern():
        kern.launches += 1

    kern.launches = 0
    return kern


@pytest.mark.parametrize("per_graph,replays", [(1, 1), (4, 5), (20, 3)])
def test_graph_ms_counts_warm_up_and_replays_not_capture(fake_cuda, per_graph, replays):
    fwd, bwd = _kernel(), _kernel()

    def step():                     # one forward, two backward launches per call
        fwd()
        bwd()
        bwd()

    bwd.launches = 7                # counts from earlier work stay
    ms = profiling.graph_ms(step, per_graph, replays, (fwd, bwd))
    # three warm-up calls, then one untimed and ``replays`` timed replays
    assert fwd.launches == 3 + per_graph * (1 + replays)
    assert bwd.launches == 7 + 2 * (3 + per_graph * (1 + replays))
    assert ms == pytest.approx(1.0 / (per_graph * replays))


def test_replays_keeps_per_replay_and_puts_counts_back(fake_cuda):
    kern = _kernel()
    run = profiling.Replays(lambda: (kern(), kern()), per_graph=3, counters=(kern,))
    assert run.per_replay == [6]
    assert kern.launches == 6       # the warm-up's three calls only
    run.replay(4)
    assert kern.launches == 6 + 4 * 6
