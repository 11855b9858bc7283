"""The launch counts (``ops.LAUNCHES``) around CUDA graphs:
``ops.GraphLaunches`` leaves a warm-up and a capture uncounted and adds
each replay's launches; ``utils.profiling``'s CUDA-graph timing, through
it, counts only the kernel launches that ran: the warm-up calls and every
replay, never the capture.

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

from coarsegrainingvae_tpu_torch import ops
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


@pytest.fixture
def launches():
    """The ledger from 0, put back as it was after the test."""
    saved = ops.read_launches()
    ops.reset_launches()
    yield ops.LAUNCHES
    ops.LAUNCHES.update(saved)


def _kernel(name):
    """A stand-in for a kernel wrapper: each call counts one launch."""
    def kern():
        ops.LAUNCHES[name] += 1

    return kern


def test_graph_launches_count_replays_not_warm_up_or_capture(fake_cuda, launches):
    fwd, bwd = _kernel("fused_message"), _kernel("fused_message_vjp")
    launches["fused_message_vjp"] = 7        # counts from earlier work stay
    graph = torch.cuda.CUDAGraph()

    def warm_up():
        for _ in range(3):
            fwd()
            bwd()

    def capture():
        with torch.cuda.graph(graph):
            fwd()
            bwd()
            bwd()

    run = ops.GraphLaunches(capture, warm_up)
    assert run.per_replay == {**dict.fromkeys(ops.KERNELS, 0), "fused_message": 1,
                              "fused_message_vjp": 2}
    assert launches == {**dict.fromkeys(ops.KERNELS, 0), "fused_message_vjp": 7}
    for _ in range(5):
        graph.replay()
    run.replayed(5)
    assert launches == {**dict.fromkeys(ops.KERNELS, 0), "fused_message": 5,
                        "fused_message_vjp": 7 + 2 * 5}


@pytest.mark.parametrize("per_graph,replays", [(1, 1), (4, 5), (20, 3)])
def test_graph_ms_counts_warm_up_and_replays_not_capture(fake_cuda, launches, per_graph,
                                                         replays):
    fwd, bwd = _kernel("fused_message"), _kernel("fused_message_vjp")

    def step():                     # one forward, two backward launches per call
        fwd()
        bwd()
        bwd()

    launches["fused_message_vjp"] = 7       # counts from earlier work stay
    ms = profiling.graph_ms(step, per_graph, replays)
    # three warm-up calls, then one untimed and ``replays`` timed replays
    assert launches["fused_message"] == 3 + per_graph * (1 + replays)
    assert launches["fused_message_vjp"] == 7 + 2 * (3 + per_graph * (1 + replays))
    assert ms == pytest.approx(1.0 / (per_graph * replays))


def test_replays_keeps_per_replay_and_puts_counts_back(fake_cuda, launches):
    kern = _kernel("fused_adam")
    run = profiling.Replays(lambda: (kern(), kern()), per_graph=3)
    assert run.graph_launches.per_replay == {**dict.fromkeys(ops.KERNELS, 0), "fused_adam": 6}
    assert launches["fused_adam"] == 6       # the warm-up's three calls only
    run.replay(4)
    assert launches["fused_adam"] == 6 + 4 * 6
