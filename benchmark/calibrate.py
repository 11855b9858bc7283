#!/usr/bin/env python3
"""Readings that set a cell's limits: the comparison's three numbers on
many seeds, for sound runs, for the lower-precision control, and for
planted faults. One process, one JSON line per seed.

    python3 benchmark/calibrate.py --workload dip_dense.train_b128 --seeds 1-12 --what sound

``--what``: "sound" (the program against the reference: a run of the cell
with a one-epoch window), "control" (the reference with fp8 products in
the program's place), "bf16_messages" (the reference with the dense
message blocks' sums in bfloat16 in the program's place), "half_batch" /
"no_exchange" (the fault planted in the reference put in the program's
place), or "program:<fault>" (the fault planted in the port:
state_unchanged, half_batch, no_exchange). Each line also gives the
worst gap of the small leaves over their own norm (``compare.own_scale``).
Limits go into ``benchmark/workloads/<cell>.json``; PERF.md gives the
readings.
"""
import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
for _path in (str(HERE.parent), str(HERE)):
    if _path not in sys.path:
        sys.path.insert(0, _path)


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True, help="e.g. 1-12 or 3,5,9")
    parser.add_argument("--what", default="sound")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    import torch

    from cgbench import compare, harness, registry

    cell = registry.resolve(args.workload)
    device = args.device if args.device == "cpu" else "cuda:0"
    for seed in seeds(args.seeds):
        t = time.perf_counter()
        if args.what == "sound" or args.what.startswith("program:"):
            fault = args.what.split(":", 1)[1] if ":" in args.what else None
            results = harness.run(cell, seed, 0.0, False, device=args.device, fault=fault)
            values = {k: max(r["numbers"][k] for r in results) for k in compare.NUMBERS}
            values.update(results[0]["own_scale"])
            values.update(losses=results[0]["losses"], ref_losses=results[0]["ref_losses"])
        else:
            inp = harness.Inputs(cell, seed)
            ref = inp.reference(cell, device)
            if args.what in ("control", "bf16_messages"):
                precision = "fp8" if args.what == "control" else args.what
                alt = inp.reference(cell, device, precision=precision)
            else:
                alt = inp.reference(cell, device, fault=args.what, shards=cell.chips)
            values = dict(compare.numbers(alt, ref), **compare.own_scale(alt, ref),
                          losses=alt["losses"], ref_losses=ref["losses"])
            if device != "cpu":
                torch.cuda.empty_cache()
        print(json.dumps({"workload": cell.name, "what": args.what, "seed": seed, **values,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
