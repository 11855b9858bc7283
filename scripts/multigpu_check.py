#!/usr/bin/env python3
"""Data-parallel training, ZeRO-1, tensor parallelism, the halo stack and the
hpo search across the GPUs of one host, one rank per card on NCCL.

    python3 -m torch.distributed.run --standalone --nproc_per_node 4 scripts/multigpu_check.py

Rank 0 builds the kernels and bench.py's 256 dipeptide frames (newman
mapping) and broadcasts the frames; then every rank runs, on its card:

1. epochs of ``--steps`` steps at bench.py's width (``chip_smoke.train_cfg``)
   at batch 128 and 32, captured (``Trainer.run_epoch_scan``): the plain
   single-card trainer over the whole batch, data-parallel over every
   rank with the replicated optimizer and with ZeRO-1, and tensor-parallel
   on a (world / 2, 2) ('data', 'model') mesh, the collectives of both
   subgroups in the graph; ZeRO-1 held bit for bit to the replicated
   optimizer, the captured TP epoch bit for bit to the same epoch run
   eagerly, then all four timed in turns (plain, dp, zero, tp, tp, zero,
   dp, plain), with the kernels' launches per rank;
2. ``chip_smoke.MULTIGPU_TRAIN_STEPS`` f32 steps at batch 128,
   data-parallel and tensor-parallel, against the plain trainer on the
   same card (``chip_smoke.TRAIN_RTOL`` of each parameter's max |ref|);
3. the halo stack (``parallel.halo``: 2 layers, F 192, cutoff 5, the covid
   recipe's width) on a random box of 10,333 atoms with ~20 neighbours
   per atom (the covid stand-in's frame has 22), its NCCL point-to-point halos
   against the unsharded ``EquiStack`` on the same card, forward and
   parameter gradients (``chip_smoke.HALO_RTOL`` of max |ref|), both passes
   timed in turns after one untimed pass each;
4. with ``--hpo``, ``cli.hpo`` with ``chip_smoke.HPO_RECIPE`` (the
   committed hpo_demo search; ``--hpo='FLAGS'`` adds FLAGS after it) over
   the same process group, every trial data-parallel over all the ranks,
   its wall time and rows.

Rank 0 prints the card, one line per check and writes them to ``--out``
(default ``multigpu_check.json`` in ``chip_smoke.OUT_DIR``, the output
directory of the repository's card runs); any failed check raises on
the rank that saw it. ``--device cpu`` rehearses the same on gloo ranks of
the CPU (``--n_basis`` and ``--batches`` shrink it).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shlex
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--batches", type=int, nargs="+", default=[128, 32])
    p.add_argument("--n_basis", type=int, default=600)
    p.add_argument("--halo_atoms", type=int, default=10333)
    p.add_argument("--halo_width", type=int, default=192)
    p.add_argument("--hpo", nargs="?", const="", default=None,
                   help="run the hpo_demo search last; --hpo='FLAGS' adds FLAGS after the "
                        "recipe's")
    p.add_argument("--out", default=None,
                   help="the report's path (default: multigpu_check.json in chip_smoke.OUT_DIR)")
    return p.parse_args(argv)


def main(argv=None) -> int:
    a = parse(argv)
    import numpy as np
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from coarsegrainingvae_tpu_torch.config import ParallelConfig
    from coarsegrainingvae_tpu_torch.data.device import DeviceDataset, epoch_index_batches
    from coarsegrainingvae_tpu_torch.data.neighbors import radius_graph_frames
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.ops import read_launches, reset_launches
    from coarsegrainingvae_tpu_torch.parallel import halo
    from coarsegrainingvae_tpu_torch.parallel.mesh import (Mesh, all_reduce_, init_distributed,
                                                           local_device, make_mesh)
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    if a.device == "cuda" and not torch.cuda.is_available():
        print("multigpu_check: no CUDA device", file=sys.stderr)
        return 1
    if not init_distributed(a.device):
        print("multigpu_check: run under torch.distributed.run (WORLD_SIZE unset)",
              file=sys.stderr)
        return 1
    cuda = a.device == "cuda"
    device = local_device(a.device)
    mesh = make_mesh(device=device)
    tp_mesh = make_mesh(model_devices=2, device=device)
    single = Mesh(0, 1, None, None, device)
    rank0 = mesh.rank == 0
    report = {"world": mesh.size, "backend": mesh.backend}

    def say(line: str) -> None:
        if rank0:
            print(line, flush=True)

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    try:
        if rank0:
            report["card"] = cs.card_line() if cuda else "cpu"
            say(f"{report['card']}; {mesh.size} {mesh.backend} ranks")
        if cuda:
            from coarsegrainingvae_tpu_torch.ops import fused_message as mo
            from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po
            from coarsegrainingvae_tpu_torch.utils import tracing

            t = time.perf_counter()
            if rank0:                           # one nvcc per source, together
                from concurrent.futures import ThreadPoolExecutor

                with ThreadPoolExecutor(2) as pool:
                    list(pool.map(lambda ops: ops.build(), (mo, po)))
            dist.barrier()
            mo.build(), po.build()
            say(f"build: {time.perf_counter() - t:.1f} s (nvcc {tracing.seconds('ops.build.')})")
        box = [cs.dipeptide_device_data(str(device))[0] if rank0 else None]
        dist.broadcast_object_list(box, src=0)
        ds = box[0]

        def dataset(n):
            return DeviceDataset.from_dataset(ds.subset(np.resize(np.arange(len(ds)), n)), device)

        model_kw = dict(n_basis=a.n_basis)
        m = cs.dipeptide_model_cfg(**model_kw)
        per_step = {"fused_message": 2 * m.enc_nconv, "fused_message_vjp": 2 * m.enc_nconv,
                    "fused_pseudo_message": m.dec_nconv, "fused_pseudo_vjp": m.dec_nconv}
        # the optimizer's launches a step: the fused step (plain and data
        # parallel), its norm alone (ZeRO-1), none (tensor parallel's plain)
        optimizer = {"plain": {"fused_adam": 1}, "dp": {"fused_adam": 1},
                     "zero": {"fused_global_norm": 1}, "tp": {}}

        # 1. captured epochs: plain, data-parallel, ZeRO-1
        report["epochs"] = {}
        for bs in a.batches:
            cfg = cs.train_cfg(bs, **model_kw)
            dds = dataset(bs * a.steps)
            idx = epoch_index_batches(dds.n_frames, bs, np.random.default_rng(1))
            runs = {}
            for label, on, zero in (("plain", single, False), ("dp", mesh, False),
                                    ("zero", mesh, True), ("tp", tp_mesh, False)):
                c = dataclasses.replace(cfg, parallel=ParallelConfig(
                    zero_optimizer=zero, model_devices=on.model_size))
                tr = Trainer(DenseCGVAE(c.model, generator=torch.Generator().manual_seed(0)), c,
                             device=device, mesh=on)
                st = tr.init_state(ds.batch(np.arange(bs)))
                gen = torch.Generator(device=device).manual_seed(11)
                reset_launches()
                st, _ = tr._run_program(st, dds, idx, gen, True, tr.captures)
                runs[label] = dict(tr=tr, st=st, launches=read_launches(),
                                   params=[p.detach().clone() for p in st.params.values()],
                                   moments=st.opt_state.mu.numel())
            exact = all(torch.equal(x, y) for x, y in zip(runs["zero"]["params"],
                                                          runs["dp"]["params"]))
            # the TP epoch again, eagerly, from the same weights and draws
            c = dataclasses.replace(cfg, parallel=ParallelConfig(model_devices=2))
            tr = Trainer(DenseCGVAE(c.model, generator=torch.Generator().manual_seed(0)), c,
                         device=device, mesh=tp_mesh)
            st = tr.init_state(ds.batch(np.arange(bs)))
            st, _ = tr._run_program(st, dds, idx, torch.Generator(device=device).manual_seed(11),
                                    True, False)
            tp_exact = all(torch.equal(p.detach(), q) for p, q in zip(st.params.values(),
                                                                      runs["tp"]["params"]))
            del tr, st
            for label, r in runs.items():
                expect = cs.counts(**{k: v * a.steps * cuda for k, v in
                                      {**per_step, **optimizer[label]}.items()})
                if r["launches"] != expect:
                    raise RuntimeError(f"rank {mesh.rank} {label} at batch {bs}: launches "
                                       f"{r['launches']}, expected {expect}")
            if not exact:
                raise RuntimeError(f"rank {mesh.rank}: ZeRO-1 differs from the replicated "
                                   f"optimizer at batch {bs}")
            if not tp_exact:
                raise RuntimeError(f"rank {mesh.rank}: the captured TP epoch differs from the "
                                   f"eager one at batch {bs}")
            times = {k: [] for k in runs}
            for label in ("plain", "dp", "zero", "tp", "tp", "zero", "dp", "plain"):
                r = runs[label]
                gen = torch.Generator(device=device).manual_seed(12)
                dist.barrier()
                sync()
                t = time.perf_counter()
                r["st"], _ = r["tr"]._run_program(r["st"], dds, idx, gen, True, r["tr"].captures)
                sync()
                times[label].append((time.perf_counter() - t) / a.steps * 1e3)
            n_params = sum(p.numel() for p in runs["plain"]["st"].params.values())
            row = {"batch": bs, "rows_per_rank": bs // mesh.size, "ms_per_step": times,
                   "zero_equal": exact, "moments": {k: r["moments"] for k, r in runs.items()},
                   "launches_per_rank": runs["dp"]["launches"],
                   "tp_launches_per_rank": runs["tp"]["launches"], "tp_captured_equal": tp_exact,
                   "tp_mesh": tp_mesh.shape, "tp_shard_mb": sum(
                       t.numel() * t.element_size()
                       for t in runs["tp"]["tr"].shards(runs["tp"]["st"]).values()) / 1e6,
                   "captured": runs["dp"]["tr"].captures, "all_reduce_mb": 4 * n_params / 1e6}
            report["epochs"][bs] = row
            say(f"batch {bs} ({bs // mesh.size} rows per rank), {a.steps}-step epochs "
                f"{'captured' if row['captured'] else 'in a loop'}: plain one card "
                f"{', '.join(f'{x:.3f}' for x in times['plain'])} ms/step; data-parallel "
                f"{', '.join(f'{x:.3f}' for x in times['dp'])}; ZeRO-1 "
                f"{', '.join(f'{x:.3f}' for x in times['zero'])} (bit for bit the replicated "
                f"optimizer {exact}; moments per rank {runs['zero']['moments']} of {n_params}); "
                f"tensor-parallel on mesh {tp_mesh.shape} "
                f"{', '.join(f'{x:.3f}' for x in times['tp'])} (captured bit for bit the eager "
                f"epoch {tp_exact}; moments per rank {runs['tp']['moments']}, shards "
                f"{row['tp_shard_mb']:.1f} MB); launches per rank {row['launches_per_rank']}, "
                f"TP {row['tp_launches_per_rank']}; all-reduce "
                f"{row['all_reduce_mb']:.1f} MB per step")
            for r in runs.values():
                r["tr"].release_graphs()
            del runs, dds
            if cuda:
                torch.cuda.empty_cache()

        # 2. f32 steps, data-parallel against the plain trainer
        bs = a.batches[0]
        cfg = cs.train_cfg(bs, compute_dtype="float32", **model_kw)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train,
                                                                 adam_moment_dtype="float32"))
        order = np.resize(np.random.default_rng(3).permutation(len(ds)),
                          bs * cs.MULTIGPU_TRAIN_STEPS)
        params = {}
        for label, on in (("plain", single), ("dp", mesh), ("tp", tp_mesh)):
            c = dataclasses.replace(cfg, parallel=ParallelConfig(model_devices=on.model_size))
            tr = Trainer(DenseCGVAE(c.model, generator=torch.Generator().manual_seed(0)), c,
                         device=device, mesh=on)
            st = tr.init_state(ds.batch(order[:bs]))
            gen = torch.Generator(device=device).manual_seed(21)
            for i in range(cs.MULTIGPU_TRAIN_STEPS):
                st, _ = tr.train_step(st, ds.batch(order[i * bs:(i + 1) * bs]).to(device), gen)
            params[label] = [p.detach().clone() for p in st.params.values()]
            del tr, st
        err = cs.worst_rel(params["dp"], params["plain"])
        tp_err = cs.worst_rel(params["tp"], params["plain"])
        report["f32_steps_err"], report["tp_f32_steps_err"] = err, tp_err
        say(f"{cs.MULTIGPU_TRAIN_STEPS} f32 steps at batch {bs} over {mesh.size} ranks against "
            f"one card: data-parallel max|err|/max|ref| {err:.3e}, tensor-parallel on mesh "
            f"{tp_mesh.shape} {tp_err:.3e}")
        if not max(err, tp_err) <= cs.TRAIN_RTOL:
            raise RuntimeError(f"rank {mesh.rank}: f32 steps disagree (data-parallel {err:.3e}, "
                               f"tensor-parallel {tp_err:.3e})")

        # 3. the halo stack on a random box at the covid stand-in's density
        rng = np.random.default_rng(0)
        # a box three sides long in x at 0.042 atoms per cubic A: ~22
        # neighbours within 5 A inside it (the covid stand-in's edges per
        # atom), ~20 with its faces
        side = (a.halo_atoms / (3 * 0.042)) ** (1 / 3)
        xyz = (rng.uniform(0, 1, (a.halo_atoms, 3)) * np.array([3 * side, side, side])
               ).astype(np.float32)
        e, em = radius_graph_frames(xyz[None], 5.0)
        edges = e[0][em[0]]
        kw = dict(n_conv=cs.HALO_LAYERS, feat_dim=a.halo_width, n_rbf=10, activation="swish",
                  cutoff=5.0)
        plan = halo.plan_halo(xyz, edges, mesh.size, halo.min_halo(xyz, edges, mesh.size))
        stack = halo.EquiStack(**kw, generator=torch.Generator().manual_seed(0)).to(device)
        s, v = cs.halo_inputs(a.halo_atoms, a.halo_width)

        def put(arr):
            return torch.as_tensor(arr).to(device)

        def grads(so, vo):
            loss = (so ** 2).sum() + (vo ** 2).sum()
            return torch.cat([g.reshape(-1) for g in torch.autograd.grad(
                loss, list(stack.parameters()))])

        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        full = (put(s), put(v), put(xyz), torch.as_tensor(edges, dtype=torch.long).to(device))
        blocks = [put(plan.block(plan.pad(x), mesh.rank)) for x in (s, v, xyz)]
        passes = {"unsharded": lambda: stack(*full),
                  "halo": lambda: halo.halo_stack_apply(stack, *blocks, plan, mesh)}
        out, ms = {}, {k: [] for k in passes}
        # the first pass of each is set-up (NCCL's point-to-point
        # communicators, workspaces) and not timed
        for label in ("unsharded", "halo", "unsharded", "halo", "halo", "unsharded"):
            dist.barrier()
            sync()
            t = time.perf_counter()
            so, vo = passes[label]()
            g = grads(so, vo)
            if label == "halo":
                all_reduce_(g, mesh)
            sync()
            if label in out:
                ms[label].append((time.perf_counter() - t) * 1e3)
            out[label] = (so.detach(), vo.detach(), g)
        (s_ref, v_ref, g_ref), (s_h, v_h, g_h) = out["unsharded"], out["halo"]
        lo, hi = mesh.rank * plan.shard_size, (mesh.rank + 1) * plan.shard_size
        pos = plan.order[lo:hi]
        real = pos < a.halo_atoms
        errs = [cs.worst_rel([s_h[torch.as_tensor(real)]], [s_ref[torch.as_tensor(pos[real])]]),
                cs.worst_rel([v_h[torch.as_tensor(real)]], [v_ref[torch.as_tensor(pos[real])]]),
                cs.worst_rel([g_h], [g_ref])]
        peak = torch.cuda.max_memory_allocated(device) / 1e9 if cuda else None
        report["halo"] = {"atoms": a.halo_atoms, "edges": int(len(edges)), "halo": plan.halo,
                          "shard": plan.shard_size, "errors_rank0": errs, "ms": ms,
                          "peak_gb_rank0": peak}
        say(f"halo stack over {mesh.size} ranks: {a.halo_atoms} atoms, {len(edges)} edges, F "
            f"{a.halo_width}, {cs.HALO_LAYERS} layers; slabs of {plan.shard_size}, halo "
            f"{plan.halo}; rank 0 against the unsharded stack: s {errs[0]:.3e}, v {errs[1]:.3e}, "
            f"parameter gradients {errs[2]:.3e}; forward+backward ms: unsharded one card "
            f"{', '.join(f'{x:.2f}' for x in ms['unsharded'])}, sharded "
            f"{', '.join(f'{x:.2f}' for x in ms['halo'])}; rank 0 peak "
            + (f"{peak:.3f} GB" if cuda else "n/a"))
        if not max(errs) <= cs.HALO_RTOL:
            raise RuntimeError(f"rank {mesh.rank}: the halo stack disagrees ({errs})")

        # 4. the hpo search, every trial over all the ranks
        if a.hpo is not None:
            from coarsegrainingvae_tpu_torch.cli import hpo

            logdir = ROOT / "build" / "multigpu_hpo"
            flags = cs.HPO_RECIPE + shlex.split(a.hpo) + ["-logdir", str(logdir),
                                                          "--device", a.device]
            a_hpo = hpo.build_parser().parse_args(flags)
            if rank0:
                cs.dipeptide_data(str(device), a_hpo.ndata)
            dist.barrier()
            os.environ["COARSEGRAININGVAE_DATA"] = str(ROOT / cs.OUT_DIR / "cv_data")
            sync()
            t = time.perf_counter()
            best, value = hpo.main(flags)
            sync()
            wall = time.perf_counter() - t
            rows = cs.read_csv(logdir / "hpo_asha_log.csv")[1] if rank0 else []
            report["hpo"] = {"seconds": wall, "best": best, "value": value, "rows": rows}
            say(f"hpo over {mesh.size} ranks ({' '.join(flags)}): {len(rows)} trial runs in "
                f"{wall:.1f} s; per run (rung, epochs, n_basis, value, wall s) "
                f"{[(r['rung'], r['epochs'], r['n_basis'], r['value'], r['wall_s']) for r in rows]}"
                f"; best {value:.4f}")
            if rank0 and any(r["failed"] != "False" for r in rows):
                raise RuntimeError("hpo over the ranks: a trial failed")
        dist.barrier()
        if rank0:
            out = Path(a.out) if a.out else ROOT / cs.OUT_DIR / "multigpu_check.json"
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(report, indent=1))
            print(json.dumps({"ok": True, "world": mesh.size}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
