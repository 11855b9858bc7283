"""One run of one cell: set-up, the checked steps, the measured window, the
plain reference, and the result line.

Set-up builds the frames and the weights from the seed, the port's
``Trainer`` over a ``DeviceDataset`` (the ``Program`` of the configuration's
family, ``program.load``), and drives that trainer through the cell's
checked steps (three), one step per call of the epoch program, on rows of
the frames that all differ; its first call captures the step. The window
then runs whole captured epochs (``Trainer.run_epoch_scan``) until
``--seconds`` have passed, and ends at the synchronisation after the last.
With ``--trace 1`` the window is one epoch under ``torch.profiler``. Once
the window has closed and the peak memory is read, the program is freed
and the reference follows the checked steps from the same weights, rows and noise;
``compare`` decides ``correct``.

A cell on several chips runs one process per card (NCCL, or gloo on the
CPU), each the same ``run_rank``; rank 0 decides when the window closes.
"""
from __future__ import annotations

import gc
import multiprocessing
import os
import queue
import socket
import statistics
import time
import traceback
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from cgbench import compare, frames as fr, program, registry, weights as wt
from cgbench.context import Context
from cgbench.guard import forbidden_loaded
from cgbench.profiling import Trace
from cgbench.reference import train as ref_train

CHECKED_STEPS = 3          # the steps the reference follows
RANKS_TIMEOUT_S = 1100.0   # how long spawned ranks may take, cold build included


class Inputs:
    """What the benchmark hands both sides, from the seed: the frames, the
    weights' seed and layout, the noise's seed and the checked steps' rows
    (a permutation of the frames, so every row differs)."""

    def __init__(self, cell: registry.Cell, seed: int):
        cfg, traffic = cell.config, cell.traffic
        b = traffic["batch_size"]
        n_frames = b * traffic["epoch_steps"]
        self.frames = fr.make_frames(cfg["molecule"], traffic["frames"], n_frames, seed)
        with torch.device("meta"):
            self.spec = wt.leaves(ref_train.family(cfg["model"]).Model(cfg))
        self.wseed, self.nseed = fr.derived_seed(seed, fr.WEIGHTS), fr.derived_seed(seed, fr.NOISE)
        rows = fr.stream(seed, fr.ROWS).permutation(n_frames)
        self.checked = list(rows[:CHECKED_STEPS * b].reshape(-1, b))
        self.lr = cfg["lr_per_sample"] * b

    def reference(self, cell: registry.Cell, device, **kwargs) -> dict:
        """The reference's readings of the checked steps (``readings``'s
        keywords: the control's ``precision``, a planted ``fault``)."""
        return ref_train.readings(cell.config, self.frames, self.checked, self.lr, self.nseed,
                                  wt.draw(self.spec, self.wseed, device), device, **kwargs)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _agree(go: bool, device: torch.device) -> bool:
    """Rank 0's ``go``, on every rank."""
    import torch.distributed as dist

    if not dist.is_initialized():
        return go
    flag = torch.tensor([int(go)], device=device)
    dist.broadcast(flag, 0)
    return bool(flag.item())


def _failed(m: dict) -> int:
    n = int(m["n_steps"])
    if not np.isfinite(m["loss"]):
        return n
    return int(round(m.get("skipped", 0.0) * n))


def _drive(prog: program.TrainerProgram, cell: registry.Cell, inp: Inputs, seed: int,
           seconds: float, trace: bool, device: torch.device) -> dict:
    """The checked steps, then the window."""
    import torch.distributed as dist

    # the checked steps: the window's epoch program, rows that all differ
    gen = torch.Generator(device=device).manual_seed(inp.nseed)
    losses, grad_norms = [], None
    for r in inp.checked:
        losses.append(prog.steps(r[None], gen)["loss"])
        if grad_norms is None:
            grad_norms = prog.first_moment_norms().cpu()
    read = {"losses": losses, "grad_norms": grad_norms, "names": prog.names,
            "change_norms": prog.change_norms(wt.draw(inp.spec, inp.wseed, device)).cpu()}

    # the window
    rng = fr.stream(seed, fr.EPOCHS)
    _sync(device)
    if dist.is_initialized():
        dist.barrier()
    out = {"read": read, "window_start": time.time(), "steps": 0, "failed": 0, "trace": None}
    t0 = time.perf_counter()

    def epoch():
        m = prog.epoch(gen, rng)
        out["steps"] += int(m["n_steps"])
        out["failed"] += _failed(m)

    if trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        with profile(activities=acts) as prof:
            epoch()
            _sync(device)
            out["window_s"] = time.perf_counter() - t0
        out["trace"] = Trace.from_profiler(prof, out["window_s"], out["steps"])
    else:
        epoch()
        while _agree(time.perf_counter() - t0 < seconds, device):
            epoch()
        _sync(device)
        out["window_s"] = time.perf_counter() - t0
    out["peak"] = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    return out


def run_rank(cell: registry.Cell, seed: int, seconds: float, trace: bool, device,
             fault: Optional[str] = None, root: Path = registry.ROOT) -> dict:
    """This process's share of one run; see the module docstring."""
    import torch.distributed as dist

    device = torch.device(device)
    inp = Inputs(cell, seed)
    with program.plant(fault):
        prog = program.load(cell.config["model"])(cell.config, cell.traffic, inp.frames,
                               wt.draw(inp.spec, inp.wseed, device), device)
        run = _drive(prog, cell, inp, seed, seconds, trace, device)
        forbidden = forbidden_loaded()
        prog.release()
    del prog

    # the reference, once the peak is read and the program freed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    ref = inp.reference(cell, device, count_flops=trace)
    out = {k: run[k] for k in ("window_start", "window_s", "steps", "failed", "peak")}
    out.update(numbers=compare.numbers(run["read"], ref),
               own_scale=compare.own_scale(run["read"], ref), losses=run["read"]["losses"],
               ref_losses=ref["losses"],
               forbidden=forbidden,
               kind=torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu")
    tr = run["trace"]
    if tr is not None:
        out["busy_s"] = tr.busy_s()
        if not dist.is_initialized() or dist.get_rank() == 0:
            ctx = Context(tr, cell.config, cell.traffic, cell.chips, inp.frames, ref["flops"])
            out["per_layer"] = registry.read_metrics(cell, ctx, root)
            out["breakdown"] = {"device_ops": tr.top_ops(), "idle_gaps": tr.idle_gaps()}
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, backend: str, name: str, root: str,
               seed: int, seconds: float, trace: bool, fault: Optional[str], results) -> None:
    import torch.distributed as dist

    os.environ["LOCAL_RANK"] = str(rank)
    try:
        torch.set_num_threads(1 if backend == "gloo" else torch.get_num_threads())
        device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
        kwargs = {}
        if backend == "nccl":
            torch.cuda.set_device(device)
            kwargs["device_id"] = device
        dist.init_process_group(backend, init_method=f"tcp://localhost:{port}", rank=rank,
                                world_size=world, **kwargs)
        try:
            cell = registry.resolve(name, Path(root))
            results.put((rank, True, run_rank(cell, seed, seconds, trace, device, fault,
                                              Path(root))))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
        raise


def run(cell: registry.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        fault: Optional[str] = None, root: Path = registry.ROOT) -> List[dict]:
    """Every rank's ``run_rank`` result, in rank order: in this process for
    one chip, else in one spawned process per chip (NCCL on cards, gloo on
    the CPU), each of which has ended when this returns."""
    if cell.chips == 1:
        return [run_rank(cell, seed, seconds, trace, device if device == "cpu" else "cuda:0",
                         fault, root)]
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    backend = "nccl" if device != "cpu" else "gloo"
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, cell.chips, port, backend, cell.name,
                                                   str(root), seed, seconds, trace, fault,
                                                   results))
             for r in range(cell.chips)]
    for p in procs:
        p.start()
    out, errors = {}, []
    deadline = time.monotonic() + RANKS_TIMEOUT_S
    try:
        while len(out) + len(errors) < cell.chips:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"the ranks did not finish within {RANKS_TIMEOUT_S} s")
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)
                        and r not in out]
                if dead:
                    time.sleep(2.0)
                    if results.empty():
                        errors.append(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                continue
            if ok:
                out[rank] = value
            else:
                errors.append(f"rank {rank}:\n{value}")
    finally:
        for p in procs:
            p.join(timeout=30 if not errors else 2)
            if p.is_alive():
                p.terminate()
                p.join()
    if errors:
        raise RuntimeError("a rank failed: " + "\n".join(errors))
    return [out[r] for r in range(cell.chips)]


def compose(cell: registry.Cell, results: List[dict], trace: bool, start: float,
            platform: str = "gpu") -> tuple:
    """(the result line, the lines of numbers beside their limits)."""
    r0 = results[0]
    limits = cell.workload["limits"]
    values = {k: max(r["numbers"][k] for r in results) for k in compare.NUMBERS}
    correct = compare.judge(values, limits) and r0["failed"] == 0
    peak = max(r["peak"] for r in results)
    if trace:
        metrics = r0.get("per_layer", {})
    else:
        e2e = {"train_samples_per_s": (r0["steps"] * cell.traffic["batch_size"] / r0["window_s"],
                                       "samples/s"),
               "peak_mem_gb": (peak / 1e9, "GB"),
               "setup_s": (max(r["window_start"] for r in results) - start, "s")}
        metrics = {m["name"]: {"value": e2e[m["name"]][0], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": platform, "kind": r0["kind"], "count": cell.chips,
              "memory_peak_bytes": peak}
    if trace:
        device["busy_s"] = statistics.fmean(r["busy_s"] for r in results)
        device["window_s"] = statistics.fmean(r["window_s"] for r in results)
    line = {"correct": bool(correct), "attempted": r0["steps"], "failed": r0["failed"],
            "metrics": metrics, "device": device}
    if trace and "breakdown" in r0:
        line["breakdown"] = r0["breakdown"]
    checks = {k: {"value": values[k], "limit": limits[k]} for k in compare.NUMBERS}
    checks["failed_steps"] = {"value": r0["failed"], "limit": 0}
    line["checks"] = checks
    text = [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in checks.items()]
    return line, text
