"""The readers of the program's own spans and phase marks on a synthetic
trace: ``step.forward_ms``, ``step.backward_ms``, ``step.optimizer_ms``,
``step.graph_idle_ms`` (device marks) and ``setup.dataset_s``,
``setup.capture_s`` (host spans); each gives None where the program has
neither, as a program from before the marks has not."""
import sys

import pytest

from cgbench import registry
from cgbench.context import Context
from cgbench.profiling import Trace
from coarsegrainingvae_tpu_torch.utils import tracing

US = 1e-6
STEP_S = 0.01   # one replay every 10 ms; the 9.5 ms between them lie outside the steps


def _step(t0, exchange=False):
    """One step's device intervals from t0: each mark 1 us long, 1 us gaps
    between every interval, work of 8 / 87 / 197 / 97 / 7 us after the
    step / forward / backward / optimizer / bookkeeping marks (and 50 us
    after the exchange mark)."""
    work = {"step": 8, "forward": 87, "backward": 197, "exchange": 50, "optimizer": 97,
            "bookkeeping": 7}
    out, t = [], t0
    for mark in tracing.MARKS:
        if mark == "exchange" and not exchange:
            continue
        out.append((tracing.kernel_name(mark), t, t + US))
        t += 2 * US
        if mark in work:
            out.append((f"kernel_after_{mark}", t, t + work[mark] * US))
            t += (work[mark] + 1) * US
    return out


def _trace(n=3, exchange=False, marks=True):
    kernels = [k for i in range(n) for k in _step(1.0 + i * STEP_S, exchange)]
    if not marks:
        kernels = [k for k in kernels if not k[0].startswith("cgvae_mark_")]
    return Trace(kernels, [("cudaGraphLaunch", 1.0 + i * STEP_S - 5 * US, 1.0 + i * STEP_S)
                           for i in range(n)], n * STEP_S, n)


def _ctx(trace):
    return Context(trace, {}, {"batch_size": 32}, 1, None, None)


def _read(metric, trace):
    return registry.reader(metric)(_ctx(trace))


@pytest.mark.parametrize("exchange", [False, True], ids=["one-rank", "data-parallel"])
def test_phase_readers_measure_mark_to_mark(exchange):
    t = _trace(exchange=exchange)
    assert _read("step.forward_ms", t) == pytest.approx(0.090)     # 1 + 1 + 87 + 1 us
    assert _read("step.backward_ms", t) == pytest.approx(0.200)    # to exchange or optimizer
    assert _read("step.optimizer_ms", t) == pytest.approx(0.100)


@pytest.mark.parametrize("exchange", [False, True], ids=["one-rank", "data-parallel"])
def test_graph_idle_is_the_gaps_inside_each_step_alone(exchange):
    """Every interval is followed by a 1 us gap inside the step (the last
    mark excepted), and the time between replays is left out."""
    n_intervals = sum(1 for _ in _step(0.0, exchange))
    got = _read("step.graph_idle_ms", _trace(exchange=exchange))
    assert got == pytest.approx((n_intervals - 1) * 1e-3)


def test_overlapping_device_work_is_busy_once():
    t = _trace(n=1)
    a, b = t.kernels[2][1], t.kernels[2][2]        # the forward's work
    t.kernels.append(("other_stream", a - 0.5 * US, b + 0.5 * US))
    assert _read("step.graph_idle_ms", t) == pytest.approx(
        _read("step.graph_idle_ms", _trace(n=1)) - 1e-3)


def test_phase_readers_give_none_without_marks(monkeypatch):
    for metric in ("step.forward_ms", "step.backward_ms", "step.optimizer_ms",
                   "step.graph_idle_ms"):
        assert _read(metric, _trace(marks=False)) is None
    # a program from before the marks: no utils/tracing.py to import
    monkeypatch.setitem(sys.modules, "coarsegrainingvae_tpu_torch.utils.tracing", None)
    monkeypatch.delattr(sys.modules["coarsegrainingvae_tpu_torch.utils"], "tracing")
    for metric in ("step.forward_ms", "step.graph_idle_ms", "setup.dataset_s",
                   "setup.capture_s"):
        assert _read(metric, _trace()) is None


def test_setup_readers_sum_this_processes_spans(monkeypatch):
    reg = tracing.Registry()
    monkeypatch.setattr(tracing, "REGISTRY", reg)
    assert _read("setup.dataset_s", _trace()) is None
    assert _read("setup.capture_s", _trace()) is None
    for name in ("data.build_dataset", "data.build_dataset", "train.capture", "other"):
        with reg.span(name):
            pass
    want = sum(s.seconds for s in reg.find("data.build_dataset"))
    assert _read("setup.dataset_s", _trace()) == pytest.approx(want)
    assert _read("setup.capture_s", _trace()) == pytest.approx(reg.find("train.capture")[0].seconds)


def test_every_cell_lists_the_new_metrics():
    cells = [w for w in registry.load_json(registry.ROOT / "BENCHMARK.json")["workloads"]]
    for w in cells:
        names = {m["name"] for m in registry.resolve(w["name"]).per_layer}
        assert names >= {"step.forward_ms", "step.backward_ms", "step.optimizer_ms",
                         "step.graph_idle_ms", "setup.dataset_s", "setup.capture_s"}


def test_a_traced_cpu_run_reports_its_dataset_span(tiny_root):
    """At a tiny width on the CPU: the set-up span is read; the CPU
    program captures nothing and its marks are no device kernels, so the
    capture and the step phases are left out."""
    from cgbench import harness

    cell = registry.resolve("dip_dense.train_b32", tiny_root)
    line, _ = harness.compose(cell, harness.run(cell, 2**31 + 21, 0.0, True, device="cpu",
                                                root=tiny_root), True, 0.0, platform="cpu")
    metrics = line["metrics"]
    assert line["correct"] is True and metrics["setup.dataset_s"]["value"] > 0
    assert metrics["setup.dataset_s"]["unit"] == "s"
    assert not {"setup.capture_s", "step.forward_ms", "step.graph_idle_ms"} & set(metrics)
