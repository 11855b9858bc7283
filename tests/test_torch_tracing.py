"""The port's spans and counters (``utils.tracing``): the registry, the
span clock against ``torch.profiler``'s, the train step's phase marks in
the CPU epoch program, and the profiling helpers that read them.

On the CPU a mark writes ``time.perf_counter_ns()`` into the program's
host table; on a card it is a kernel node of the captured step
(tests/test_torch_gpu.py)."""
import json
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from coarsegrainingvae_tpu_torch.config import DataConfig, ExperimentConfig, ModelConfig, TrainConfig
from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.parallel.mesh import make_mesh
from coarsegrainingvae_tpu_torch.train import trainer as trainer_mod
from coarsegrainingvae_tpu_torch.train.trainer import Trainer
from coarsegrainingvae_tpu_torch.utils import profiling, tracing

torch.set_num_threads(1)

BATCH = 4
# the marks a dense train step records on one process, in order
STEP_ORDER = ["step", "forward", "decode", "loss", "backward", "optimizer", "bookkeeping", "end"]


# ---------------------------------------------------------------- registry
def test_spans_record_times_parents_and_threads():
    reg = tracing.Registry()
    with reg.span("outer"):
        with reg.span("inner"):
            time.sleep(0.002)
        with reg.span("inner"):
            pass

    @reg.span("decorated")
    def work(x):
        return x + 1

    assert work(1) == 2 and work(2) == 3
    names = [(s.name, s.parent) for s in reg.spans]
    assert names == [("inner", "outer"), ("inner", "outer"), ("outer", None),
                     ("decorated", None), ("decorated", None)]
    inner, _, outer = list(reg.spans)[:3]
    assert outer.start_ns <= inner.start_ns < inner.end_ns <= outer.end_ns
    assert inner.seconds >= 0.002
    assert len(reg.find("inner")) == 2 and reg.find("missing") == []
    assert {s.thread for s in reg.spans} == {__import__("threading").get_ident()}


def test_a_span_that_raises_is_recorded_and_closed():
    reg = tracing.Registry()
    with pytest.raises(ValueError):
        with reg.span("failing"):
            raise ValueError("boom")
    with reg.span("next"):
        pass
    assert [(s.name, s.parent) for s in reg.spans] == [("failing", None), ("next", None)]


def test_registry_keeps_the_last_max_spans():
    reg = tracing.Registry(max_spans=5)
    for i in range(8):
        with reg.span(f"s{i}"):
            pass
    assert [s.name for s in reg.spans] == ["s3", "s4", "s5", "s6", "s7"]
    assert tracing.MAX_SPANS == 10_000 and tracing.REGISTRY.spans.maxlen == tracing.MAX_SPANS


def test_seconds_sum_spans_by_the_rest_of_their_name():
    reg = tracing.Registry()
    for name in ("ops.build.a", "ops.build.b", "ops.build.a", "native.build.a"):
        with reg.span(name):
            time.sleep(0.001)
    got = reg.seconds("ops.build.")
    assert set(got) == {"a", "b"}
    want_a = sum(s.seconds for s in reg.find("ops.build.a"))
    assert got["a"] == pytest.approx(want_a) and got["a"] >= 0.002
    assert reg.seconds("nothing.") == {}


def test_snapshot_is_json_data_of_spans_since_and_counters():
    reg = tracing.Registry()
    with reg.span("early"):
        pass
    since = time.time_ns()
    with reg.span("late"):
        pass
    reg.counters["step.forward_ms"] = 1.5
    snap = json.loads(json.dumps(reg.snapshot()))
    assert [s["name"] for s in snap["spans"]] == ["early", "late"]
    assert set(snap["spans"][0]) == {"name", "start_ns", "end_ns", "parent", "thread", "seconds"}
    assert snap["counters"] == {"step.forward_ms": 1.5}
    assert [s["name"] for s in reg.snapshot(since_ns=since)["spans"]] == ["late"]
    assert tracing.Registry().snapshot() == {"spans": [], "counters": {}}


def test_span_clock_brackets_a_profiler_event():
    """Spans use the clock of the events torch.profiler records
    (``time.time_ns``, not ``perf_counter_ns``), so a span lies beside a
    trace: a span around a ``record_function`` range brackets its event."""
    from torch.profiler import ProfilerActivity, profile, record_function

    reg = tracing.Registry()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with reg.span("outer"):
            with record_function("probe"):
                torch.ones(64).sum()
    (span,) = reg.spans
    (event,) = [e for e in prof.profiler.kineto_results.events() if e.name() == "probe"]
    start = event.start_ns()
    assert span.start_ns <= start <= start + event.duration_ns() <= span.end_ns


# ------------------------------------------------------------ phase means
def test_phase_means_tile_the_step_and_skip_unrecorded_marks():
    times = np.array([[100, 300, 600, 0, 1100, 1700, 2000],
                      [3000, 3200, 3700, 0, 4000, 4900, 5000]], dtype=np.int64) * 1000
    means = tracing.phase_means(times)
    assert means == pytest.approx({"gather": 0.2, "forward": 0.4, "backward": 0.4,
                                   "optimizer": 0.75, "bookkeeping": 0.2, "total": 1.95})
    phases = sum(v for k, v in means.items() if k != "total")
    assert phases == pytest.approx(means["total"])
    assert tracing.phase_means(np.zeros((3, 7), dtype=np.int64)) == {}
    assert [tracing.kernel_name(m) for m in tracing.MARKS][0] == "cgvae_mark_step"
    assert list(tracing.PHASES) == list(tracing.MARKS[:-1])


def test_part_means_run_from_a_forward_mark_to_the_next_recorded_mark():
    """decode runs to loss, loss to backward (the next mark of either
    kind); the phases still tile the step, forward spanning forward to
    backward, and a table without the forward's marks has no parts."""
    phases = np.array([[100, 300, 600, 0, 1100, 1700, 2000],
                       [3000, 3200, 3700, 0, 4000, 4900, 5000]], dtype=np.int64) * 1000
    parts = np.array([[350, 550], [3300, 3500]], dtype=np.int64) * 1000
    times = np.concatenate([phases, parts], axis=1)
    assert list(tracing.COLUMNS) == list(tracing.MARKS) + ["decode", "loss"]
    assert tracing.part_means(times) == pytest.approx({"decode": 0.2, "loss": 0.125})
    assert tracing.phase_means(times) == pytest.approx(tracing.phase_means(phases))
    assert tracing.part_means(phases) == {}
    sparse = times.copy()
    sparse[:, tracing.COLUMNS.index("decode")] = 0
    assert tracing.part_means(sparse) == pytest.approx({"loss": 0.125})


# ------------------------------------------------------ the epoch program
@pytest.fixture(scope="module")
def dataset():
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=12, seed=0, device="cpu")
    return build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z,
                         bonds, order=2)


def _trainer(dataset, mesh=None):
    cfg = ExperimentConfig(
        model=ModelConfig(n_cgs=3, n_basis=16, n_rbf=4, enc_nconv=1, dec_nconv=1,
                          dec_type="pseudo", breaksym=True, compute_dtype="float32"),
        data=DataConfig(batch_size=BATCH),
        train=TrainConfig(lr=1e-3, gamma=25.0, adam_moment_dtype="bfloat16"))
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device="cpu", mesh=mesh)
    return tr, tr.init_state(dataset.batch(np.arange(BATCH)))


def _epoch(tr, state, dds, seed=3):
    """One run_epoch_scan from ``state``: (metrics, parameters, moments)."""
    state, m = tr.run_epoch_scan(state, dds, torch.Generator().manual_seed(seed),
                                 shuffle_rng=np.random.default_rng(seed))
    opt = state.opt_state
    return m, [p.detach().clone() for p in state.params.values()], \
        [opt.mu.clone(), opt.nu.clone(), opt.count.clone(), state.step.clone()]


@pytest.fixture
def one_gloo_rank(tmp_path):
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        yield make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("ranked", [False, True], ids=["one-process", "one-gloo-rank"])
def test_cpu_epoch_program_marks_every_step_in_order(dataset, ranked, request, monkeypatch):
    """Every step of a train epoch records its marks in order (the
    exchange only with a process group: all seven then), each step's
    phases tile its host time from the first mark to the last within 5 %,
    and the counters hold the epoch's phase means."""
    mesh = request.getfixturevalue("one_gloo_rank") if ranked else None
    tr, state = _trainer(dataset, mesh)
    dds = DeviceDataset.from_dataset(dataset, "cpu")
    host = []
    step = trainer_mod._EpochProgram.step

    def timed(self):
        t0 = time.perf_counter_ns()
        step(self)
        host.append(time.perf_counter_ns() - t0)

    monkeypatch.setattr(trainer_mod._EpochProgram, "step", timed)
    tracing.REGISTRY.counters.clear()
    m, _, _ = _epoch(tr, state, dds)
    n = m["n_steps"]
    times = tr._programs[(id(dds), True)].marks.times[:n].numpy()
    used = [tracing.MARKS.index(k) for k in tracing.MARKS if ranked or k != "exchange"]
    assert len(used) == (7 if ranked else 6)
    assert (np.diff(times[:, used], axis=1) > 0).all()
    assert not times[:, sorted(set(range(7)) - set(used))].any()
    assert len(host) == n
    total = times[:, used[-1]] - times[:, used[0]]
    np.testing.assert_allclose(total, host, rtol=0.05)
    means = tracing.phase_means(times)
    counters = tracing.REGISTRY.counters
    assert counters["step.steps"] == n
    assert ("step.exchange_ms" in counters) == ranked
    for phase, value in means.items():
        assert counters[f"step.{phase}_ms"] == pytest.approx(value)
    assert sum(v for k, v in means.items() if k != "total") == pytest.approx(means["total"])


def test_the_forward_phase_marks_its_decoder_and_loss_in_order(dataset):
    """In the dense model's CPU epoch program (no capture), ``decode`` and
    ``loss`` come in that order between ``forward`` and ``backward`` in
    every step; the counters hold ``step.decode_ms`` and ``step.loss_ms``,
    and ``step.forward_ms`` still spans ``forward`` to ``backward``."""
    tr, state = _trainer(dataset)
    dds = DeviceDataset.from_dataset(dataset, "cpu")
    tracing.REGISTRY.counters.clear()
    m, _, _ = _epoch(tr, state, dds)
    times = tr._programs[(id(dds), True)].marks.times[:m["n_steps"]].numpy()
    order = [tracing.COLUMNS.index(k) for k in STEP_ORDER]
    assert (np.diff(times[:, order], axis=1) > 0).all()
    assert not times[:, tracing.COLUMNS.index("exchange")].any()
    counters = tracing.REGISTRY.counters
    col = {k: times[:, tracing.COLUMNS.index(k)].astype(np.float64) * 1e-6
           for k in ("forward", "decode", "loss", "backward")}
    assert counters["step.decode_ms"] == pytest.approx(np.mean(col["loss"] - col["decode"]))
    assert counters["step.loss_ms"] == pytest.approx(np.mean(col["backward"] - col["loss"]))
    assert counters["step.forward_ms"] == pytest.approx(np.mean(col["backward"] - col["forward"]))
    assert counters["step.forward_ms"] > counters["step.decode_ms"] + counters["step.loss_ms"]


def test_marks_leave_the_arithmetic_bit_for_bit(dataset, monkeypatch):
    """An epoch with the marks and one with ``tracing.mark`` a no-op, from
    the same state and draws: the same parameters, moments and metrics."""
    runs = []
    for stub in (False, True):
        if stub:
            monkeypatch.setattr(tracing, "mark", lambda name: None)
        tr, state = _trainer(dataset)
        runs.append(_epoch(tr, state, DeviceDataset.from_dataset(dataset, "cpu")))
    (m_a, p_a, o_a), (m_b, p_b, o_b) = runs
    assert m_a == m_b
    for a, b in zip(p_a + o_a, p_b + o_b):
        assert torch.equal(a, b)


def test_eager_steps_and_eval_programs_record_no_mark(dataset, monkeypatch):
    """Outside a train epoch program a mark does nothing: the eager
    ``train_step`` and the eval program record none; a train epoch of the
    dense model records len(MARKS) - 1 a step on one process, with its
    forward phase's two marks between ``forward`` and ``backward``."""
    calls = []
    record = tracing.StepMarks.record
    monkeypatch.setattr(tracing.StepMarks, "record",
                        lambda self, name: (calls.append(name), record(self, name)))
    tr, state = _trainer(dataset)
    dds = DeviceDataset.from_dataset(dataset, "cpu")
    tr.train_step(state, dataset.batch(np.arange(BATCH)), torch.Generator().manual_seed(0))
    tr.run_epoch_scan_eval(state.params, dds, torch.Generator().manual_seed(1))
    assert calls == [] and tracing.REGISTRY.marks is None
    assert tr._programs[(id(dds), False)].marks is None
    batches = epoch_index_batches(dds.n_frames, BATCH, None)
    tr._run_program(state, dds, batches, torch.Generator().manual_seed(2), True, False)
    assert calls == STEP_ORDER * batches.shape[0]
    assert tracing.REGISTRY.marks is None


def test_build_dataset_is_a_span(dataset):
    before = len(tracing.find("data.build_dataset"))
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=4, seed=1, device="cpu")
    build_dataset(newman_mapping(bonds, z.shape[0], 3, seed=0), frames, 8.5, 9.5, z, bonds)
    spans = tracing.find("data.build_dataset")
    assert len(spans) == before + 1 and spans[-1].seconds > 0


def test_a_native_build_is_a_span(tmp_path, monkeypatch):
    """Each g++ build is recorded as ``native.build.<source>`` (the seconds
    ``tracing.seconds("native.build.")`` gives by source)."""
    from coarsegrainingvae_tpu_torch.native import build, cell_list

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_LIBS", {})
    before = tracing.seconds("native.build.").get("cell_list", 0.0)
    build.load("cell_list", cell_list._SYMBOLS)
    assert tracing.seconds("native.build.")["cell_list"] > before
    assert tracing.find("native.build.cell_list")[-1].parent is None


# ------------------------------------------------------ profiling helpers
class _Event:
    def __init__(self, name, device, start, end, annotation=False):
        from torch.autograd import DeviceType

        self.name = name
        self.device_type = DeviceType.CUDA if device else DeviceType.CPU
        self.is_user_annotation = annotation
        self.time_range = type("R", (), {"start": start, "end": end,
                                         "elapsed_us": lambda self: end - start})()


def test_device_profile_counts_graph_launches_and_skips_annotations():
    events = [_Event("cudaGraphLaunch", False, 0, 5), _Event("cudaLaunchKernel", False, 6, 7),
              _Event("cuGraphLaunch", False, 8, 9), _Event("aten::add", False, 0, 10),
              _Event("kernel_a", True, 10, 20), _Event("kernel_b", True, 15, 30),
              _Event("probe", True, 0, 100, annotation=True)]
    prof = type("P", (), {"events": lambda self: events})()
    p = profiling.device_profile(prof, wall_ms=0.1, steps=2)
    assert p["host_launch_calls_per_step"] == 1.5
    assert p["busy_ms"] == pytest.approx(0.020)
    assert p["device_events_per_step"] == 1.0
    assert [t[0] for t in p["top"]] == ["kernel_b", "kernel_a"]


def test_trace_writes_the_windows_spans_into_its_chrome_trace(tmp_path):
    with tracing.span("before.window"):
        pass
    with profiling.trace(str(tmp_path)):
        with tracing.span("in.window"):
            torch.ones(64).sum()
    doc = json.loads((tmp_path / "trace.json").read_text())
    spans = [e for e in doc["traceEvents"] if e.get("cat") == "cgvae_span"]
    assert [e["name"] for e in spans] == ["in.window"]
    (span,) = tracing.find("in.window")[-1:]
    base = int(doc.get("baseTimeNanoseconds", 0))
    assert spans[0]["ts"] == pytest.approx((span.start_ns - base) / 1e3)
    assert spans[0]["dur"] == pytest.approx(span.seconds * 1e6)
    ops = [e for e in doc["traceEvents"] if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    assert ops and min(e["ts"] for e in ops) >= spans[0]["ts"] - 1e6
