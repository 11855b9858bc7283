"""Run one function on N ranks in spawned processes, the process group
formed over a ``FileStore``: how the tests drive the data-parallel trainer
and the halo stack on the CPU (gloo), and how ``chip_smoke.py`` puts two
ranks on one card. ``torchrun`` is the launcher for real runs
(``cli.run_cgvae``).
"""
from __future__ import annotations

import multiprocessing
import queue
import time
import traceback
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist

from coarsegrainingvae_tpu_torch.parallel.mesh import TIMEOUT


def _rank_main(rank: int, world_size: int, store_path: str, backend: str, threads: int,
               fn: Callable, args: Sequence, results) -> None:
    torch.set_num_threads(threads)
    try:
        dist.init_process_group(backend, store=dist.FileStore(store_path, world_size),
                                rank=rank, world_size=world_size, timeout=TIMEOUT)
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((rank, False, traceback.format_exc()))   # the parent raises it
        raise


def spawn_ranks(fn: Callable, world_size: int, store_path: str, args: Sequence = (),
                backend: str = "gloo", threads: int = 1, timeout: float = 600.0) -> List[Any]:
    """fn(*args) on ``world_size`` spawned ranks of one process group
    (``backend``, rendezvous in the new file ``store_path``, ``threads``
    torch threads each); returns the ranks' results in rank order. ``fn``
    must be importable by name and its results picklable. Raises with the
    rank's traceback if a rank raised, and if the ranks do not finish
    within ``timeout`` seconds; every process is ended before it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, world_size, store_path, backend, threads,
                                                  fn, tuple(args), results))
             for r in range(world_size)]
    for p in procs:
        p.start()
    out, failed = {}, []
    deadline = time.monotonic() + timeout
    try:
        while len(out) + len(failed) < world_size:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks did not finish within {timeout} s")
                if not dead:
                    continue
                try:                 # its report, if it made one before it ended
                    rank, ok, value = results.get(timeout=5.0)
                except queue.Empty:
                    failed.append(f"rank {dead[0]} exited with code {procs[dead[0]].exitcode}")
                    break
            if not ok:
                failed.append(f"rank {rank}:\n{value}")
                # the others may wait on it forever, or fail on its account:
                # keep their reports too, the first cause among them
                while True:
                    try:
                        rank, ok, value = results.get(timeout=2.0)
                    except queue.Empty:
                        break
                    if not ok:
                        failed.append(f"rank {rank}:\n{value}")
                break
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=30 if not failed else 1)
            if p.is_alive():
                p.terminate()
                p.join()
    if failed:
        raise RuntimeError("a rank failed: " + "\n".join(failed))
    return [out[r] for r in range(world_size)]
