"""The port's spans and counters: one registry per process (``REGISTRY``).

Two recording points feed it:

- ``span(name)``, a context manager (or decorator) around host work of the
  set-up: ``data.build_dataset``, ``train.capture`` (the epoch program's
  warm-up steps, capture and first instantiation), ``ops.build.<source>``
  and ``native.build.<source>`` (each nvcc or g++ build). A span records
  its name, start and end on ``time.time_ns()``, the clock of the events
  ``torch.profiler`` records, so a span lies beside a trace
  (``profiling.trace`` writes the spans of its window into its Chrome
  trace), and the name of the span open around it in the same thread. The
  registry keeps the last ``MAX_SPANS``. No span is opened inside the
  replay loop or around launches.
- ``mark(name)``, a phase boundary of the train step (``MARKS``) or a
  boundary inside its forward phase (``FORWARD_MARKS``). While an epoch
  program's ``StepMarks`` is active (``marking``), a mark writes a
  timestamp into row ``counter`` of the program's (S_max, len(COLUMNS))
  int64 table: on a CUDA device a one-thread kernel named
  ``cgvae_mark_<name>`` (``csrc/step_marks.cu``) writes ``%globaltimer``,
  and a capture takes it into the graph as a node; on the CPU the call writes
  ``time.perf_counter_ns()``. Anywhere else a mark does nothing, so the
  eager API, eval, PCN and DiffPool launch nothing new. Marks read nothing
  the step computes. After each epoch the program copies the rows back
  (``record_phases``) and the counters hold each phase's and each part's
  mean ms of that epoch, ``step.<phase>_ms``, with ``step.total_ms`` and
  ``step.steps``.

A phase runs from its mark to the next mark of ``MARKS`` the step
recorded, so the phases tile the step from ``step`` to ``end`` with no
gap:

    step         the index gather
    forward      the model forward and ``vae_loss``
    backward     ``autograd.grad``
    exchange     the flat all-reduce (data-parallel only)
    optimizer    norm, guard, clip, Adam, apply, moment selects
    bookkeeping  static copies, metrics row, counter

Inside the forward phase a part runs from its mark to the next mark of
either kind the step recorded:

    decode       the dense model's decoder: its message and update layers
                 and the channel lift (``models/dense_cgvae.py``)
    loss         ``vae_loss``: recon, KL, graph and steric terms

so ``forward`` still spans ``forward`` to ``backward``; the sparse model
records no ``decode``, and its ``loss`` part runs to ``backward``.

``snapshot()`` gives the spans and counters as JSON data (``cli.run_cgvae``
writes one per fold).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import os
import threading
import time
from dataclasses import asdict, dataclass
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

# the step's boundaries, in order
MARKS = ("step", "forward", "backward", "exchange", "optimizer", "bookkeeping", "end")
# the phase that starts at each mark but the last
PHASES = {"step": "gather", "forward": "forward", "backward": "backward",
          "exchange": "exchange", "optimizer": "optimizer", "bookkeeping": "bookkeeping"}
# boundaries inside the forward phase, in order; each starts a part of that name
FORWARD_MARKS = ("decode", "loss")
# the columns of a StepMarks table
COLUMNS = MARKS + FORWARD_MARKS
MAX_SPANS = 10_000


def kernel_name(mark: str) -> str:
    """The name of the mark's kernel, as a device trace shows it."""
    return f"cgvae_mark_{mark}"


@dataclass(frozen=True)
class Span:
    name: str
    start_ns: int            # time.time_ns()
    end_ns: int
    parent: Optional[str]    # the span open around it in its thread
    thread: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


_SYMBOLS = {
    "cgvae_step_mark": ([ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                         ctypes.c_int, ctypes.c_void_p], ctypes.c_int),
}


class StepMarks:
    """An epoch program's mark table: (rows, len(COLUMNS)) int64 on the
    program's device, row i the timestamps of step i (0 where a mark was
    never recorded), written at the program's device step ``counter``."""

    def __init__(self, rows: int, counter: torch.Tensor):
        self.counter = counter
        self.times = torch.zeros((rows, len(COLUMNS)), dtype=torch.int64, device=counter.device)

    def record(self, name: str) -> None:
        col = COLUMNS.index(name)
        back = 1 if name == "end" else 0      # end follows the counter's increment
        if self.times.device.type == "cuda":
            from coarsegrainingvae_tpu_torch.ops import cuda_build

            lib = cuda_build.load("step_marks", _SYMBOLS)
            device = self.times.device
            with torch.cuda.device(device):
                err = lib.cgvae_step_mark(col, self.times.data_ptr(), self.counter.data_ptr(),
                                          self.times.shape[0], back,
                                          torch.cuda.current_stream(device).cuda_stream)
            cuda_build.check(err, kernel_name(name))
        else:
            row = int(self.counter) - back
            if 0 <= row < self.times.shape[0]:
                self.times[row, col] = time.perf_counter_ns()


def phase_means(times: np.ndarray) -> Dict[str, float]:
    """Each phase's mean ms over the steps (rows) of a mark table, and
    "total", ``step`` to ``end``; a mark no step recorded (the exchange
    on one rank) is left out, and its phase with it."""
    used = [j for j in range(len(MARKS)) if times[:, j].all()]
    if len(used) < 2:
        return {}
    t = times[:, used].astype(np.float64) * 1e-6
    gaps = np.diff(t, axis=1).mean(axis=0)
    out = {PHASES[MARKS[j]]: float(g) for j, g in zip(used, gaps)}
    out["total"] = float(np.mean(t[:, -1] - t[:, 0]))
    return out


def part_means(times: np.ndarray) -> Dict[str, float]:
    """Each part of the forward phase (``FORWARD_MARKS``) that every step
    (row) of a mark table recorded: its mean ms from its mark to the next
    mark the step recorded."""
    used = [j for j in range(times.shape[1]) if times[:, j].all()]
    t = times[:, used].astype(np.float64) * 1e-6
    out = {}
    for name in FORWARD_MARKS:
        j = COLUMNS.index(name)
        if j not in used:
            continue
        own = t[:, used.index(j)]
        nxt = np.where(t > own[:, None], t, np.inf).min(axis=1)
        if np.isfinite(nxt).all():
            out[name] = float(np.mean(nxt - own))
    return out


class Registry:
    """Spans (the last ``max_spans``) and counters of one process."""

    def __init__(self, max_spans: int = MAX_SPANS):
        self.spans: Deque[Span] = collections.deque(maxlen=max_spans)
        self.counters: Dict[str, float] = {}
        self.marks: Optional[StepMarks] = None
        self._lock = threading.Lock()
        self._open = threading.local()

    @contextlib.contextmanager
    def span(self, name: str):
        stack = self._open.__dict__.setdefault("names", [])
        parent = stack[-1] if stack else None
        stack.append(name)
        start = time.time_ns()
        try:
            yield
        finally:
            end = time.time_ns()
            stack.pop()
            with self._lock:
                self.spans.append(Span(name, start, end, parent, threading.get_ident()))

    def find(self, name: str) -> List[Span]:
        with self._lock:
            return [s for s in self.spans if s.name == name]

    def seconds(self, prefix: str) -> Dict[str, float]:
        """{the rest of the name: seconds summed} of the spans whose names
        start with ``prefix``."""
        out: Dict[str, float] = {}
        with self._lock:
            for s in self.spans:
                if s.name.startswith(prefix):
                    key = s.name[len(prefix):]
                    out[key] = out.get(key, 0.0) + s.seconds
        return out

    @contextlib.contextmanager
    def marking(self, marks: Optional[StepMarks]):
        """``mark`` writes into ``marks`` within the block (nothing, for None)."""
        prev, self.marks = self.marks, marks
        try:
            yield
        finally:
            self.marks = prev

    def mark(self, name: str) -> None:
        marks = self.marks
        if marks is not None:
            marks.record(name)

    def record_phases(self, times: np.ndarray) -> Dict[str, float]:
        """Store an epoch's phase and part means (``phase_means`` and
        ``part_means`` of its mark rows) in the counters, in place of the
        last epoch's."""
        means = dict(phase_means(times), **part_means(times))
        with self._lock:
            for k in [k for k in self.counters if k.startswith("step.")]:
                del self.counters[k]
            self.counters.update({f"step.{k}_ms": v for k, v in means.items()})
            self.counters["step.steps"] = float(times.shape[0])
        return means

    def snapshot(self, since_ns: Optional[int] = None) -> dict:
        """{"spans": [...], "counters": {...}} as JSON data; only the spans
        that start at or after ``since_ns`` (``time.time_ns()``), if given."""
        with self._lock:
            spans = [dict(asdict(s), seconds=s.seconds) for s in self.spans
                     if since_ns is None or s.start_ns >= since_ns]
            return {"spans": spans, "counters": dict(self.counters)}

    def write_chrome_spans(self, path: str, start_ns: int, end_ns: int) -> None:
        """Add the spans that overlap [start_ns, end_ns] to the Chrome trace
        ``path`` that ``torch.profiler`` exported (category ``cgvae_span``,
        this process, the span's thread)."""
        with open(path) as f:
            doc = json.load(f)
        base = int(doc.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        with self._lock:
            spans = [s for s in self.spans if s.end_ns >= start_ns and s.start_ns <= end_ns]
        doc.setdefault("traceEvents", []).extend(
            {"ph": "X", "cat": "cgvae_span", "name": s.name, "pid": pid, "tid": s.thread,
             "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"parent": s.parent}} for s in spans)
        with open(path, "w") as f:
            json.dump(doc, f)


REGISTRY = Registry()


def span(name: str):
    """``REGISTRY.span``: record the block (or the decorated function's
    calls) as the span ``name``."""
    return REGISTRY.span(name)


def mark(name: str) -> None:
    """Record the step boundary ``name`` (one of ``COLUMNS``) in the
    active epoch program's table; nothing outside one."""
    REGISTRY.mark(name)


def marking(marks: Optional[StepMarks]):
    return REGISTRY.marking(marks)


def find(name: str) -> List[Span]:
    return REGISTRY.find(name)


def seconds(prefix: str) -> Dict[str, float]:
    return REGISTRY.seconds(prefix)


def snapshot(since_ns: Optional[int] = None) -> dict:
    return REGISTRY.snapshot(since_ns)
