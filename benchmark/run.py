#!/usr/bin/env python3
"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 benchmark/run.py --workload dip_dense.train_b128 --seed 7 --seconds 20 --trace 0

From the root of a checkout, on a machine with as many CUDA cards as the
cell asks for (it exits 2, printing no result, with fewer). ``--trace 0``
reports the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a ``torch.profiler`` window. The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and ``checks``: each number
compared, beside its limit); the last lines of standard error repeat the
checks. The port's kernels build into ``build/kernels/`` of the checkout
on first use; other caches go under ``build/`` there too.
"""
import time

START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for _path in (str(ROOT), str(HERE)):
    if _path not in sys.path:
        sys.path.insert(0, _path)
for _var, _dir in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[_var] = str(ROOT / "build" / "bench_cache" / _dir)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    import torch

    from cgbench import harness, registry
    from cgbench.guard import forbidden_loaded

    cell = registry.resolve(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    results = harness.run(cell, args.seed, args.seconds, bool(args.trace))
    bad = sorted(set(forbidden_loaded()).union(*(r["forbidden"] for r in results)))
    if bad:
        print(f"modules that must not load were loaded: {bad}", file=sys.stderr)
        return 3
    line, checks = harness.compose(cell, results, bool(args.trace), START)
    for text in checks:
        print(text, file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
