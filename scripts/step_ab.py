#!/usr/bin/env python3
"""Time the captured dense train step of this checkout against another one,
in turns, on one card.

    python3 scripts/step_ab.py --parent build/parent

Turns run parent, change, change, parent, each a process started in its
checkout: it builds bench.py's 256 dipeptide frames and, per batch,
``chip_smoke.train_cfg(B)``'s trainer, captures the epoch program
(``Trainer.run_epoch_scan``), then times two epochs of ``--steps`` steps
(host clock around a synchronised epoch) and profiles 5 steps for the
device events per step. The kernels are built here once and copied into
the parent's build directory (the kernel sources must be the same; the
script checks). Prints one JSON line per turn and writes them all, with
the card's name and power limit, to ``--out``
(``chiprun_out/step_ab.json``).
"""
from __future__ import annotations

import argparse
import filecmp
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

TURN = """
import json, sys, time
sys.path.insert(0, ".")
import numpy as np, torch
from torch.profiler import ProfilerActivity, profile
import chip_smoke as cs
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.train.trainer import Trainer
torch.backends.cuda.matmul.allow_tf32 = False
ds, dataset, _, _ = cs.dipeptide_device_data()
out = {}
for b in BATCHES:
    cfg = cs.train_cfg(b)
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                 device="cuda")
    state = tr.init_state(ds.batch(np.arange(b)))
    dds, dds_prof = dataset(b * STEPS), dataset(b * 5)
    gen = torch.Generator(device="cuda").manual_seed(12)
    rng = np.random.default_rng(2)
    state, _ = tr.run_epoch_scan(state, dds, gen, shuffle_rng=rng)     # capture
    ms = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, m = tr.run_epoch_scan(state, dds, gen, shuffle_rng=rng)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t) / STEPS * 1e3)
    state, _ = tr.run_epoch_scan(state, dds_prof, gen)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state, _ = tr.run_epoch_scan(state, dds_prof, gen)
        torch.cuda.synchronize()
    p = cs.device_profile(prof, 1.0, 5)
    out[b] = {"ms_per_step": ms, "loss": m["loss"],
              "device_events_per_step": p["device_events_per_step"],
              "busy_ms_per_step": p["busy_ms"] / 5}
    tr.release_graphs()
print("TURN " + json.dumps(out))
"""


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", required=True, help="the other checkout's root")
    p.add_argument("--batches", type=int, nargs="+", default=[128, 32])
    p.add_argument("--steps", type=int, default=100)
    p.add_argument("--out", default="chiprun_out/step_ab.json")
    a = p.parse_args(argv)
    parent = Path(a.parent).resolve()
    for src in ("fused_message.cu", "fused_pseudo.cu", "pair_geometry.cuh"):
        rel = Path("coarsegrainingvae_tpu_torch") / "csrc" / src
        if not filecmp.cmp(ROOT / rel, parent / rel, shallow=False):
            raise SystemExit(f"{rel} differs between the checkouts: build each on its own")
    sys.path.insert(0, str(ROOT))
    from coarsegrainingvae_tpu_torch.ops import fused_message, fused_pseudo

    fused_message.build()
    fused_pseudo.build()
    shutil.copytree(ROOT / "build" / "kernels", parent / "build" / "kernels",
                    dirs_exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    code = TURN.replace("BATCHES", repr(a.batches)).replace("STEPS", str(a.steps))
    turns = []
    for name, tree in (("parent", parent), ("change", ROOT), ("change", ROOT),
                       ("parent", parent)):
        res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True,
                             text=True, timeout=900)
        line = [x for x in res.stdout.splitlines() if x.startswith("TURN ")]
        if res.returncode or not line:
            raise SystemExit(f"{name} turn failed:\n{res.stdout[-3000:]}\n{res.stderr[-3000:]}")
        turns.append({"tree": name, **json.loads(line[0][5:])})
        print(json.dumps(turns[-1]), flush=True)
    Path(a.out).parent.mkdir(parents=True, exist_ok=True)
    Path(a.out).write_text(json.dumps({"card": card.strip(), "turns": turns}, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
