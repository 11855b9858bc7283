#!/usr/bin/env python3
"""The kernel table on one GPU: each kernel against its plain version at
every shape ``chip_smoke.py`` times, and kernel by kernel at the shapes of
the kernel shape table (``examples/profile_kernels_torch.py``).

    python3 scripts/kernel_table.py [--kernel pseudo]

Each row is ``chip_smoke.check_kernels``' on the inputs
``chip_smoke.kernel_inputs`` makes: the kernel's ms, the plain version's ms
and the plain version's ms under ``torch.compile`` (``dynamic=False``; a
yardstick the port never runs), each as replays of a CUDA graph
(``utils.profiling.graph_ms``, sized so that one graph does ~50 ms of
work), the roofline bound (``utils.profiling.kernel_cost``) and the share
of it the kernel reaches, the kernel's and the compiled version's error
against the plain version, and the compile's seconds. Raises if a kernel
misses ``chip_smoke.KERNEL_RTOL``. Prints the card, a line per row as it
goes and the rows as JSON lines, and writes them to
``chiprun_out/kernel_table.json``. Needs one CUDA device; imports nothing
of JAX. ``--kernel message`` or ``--kernel pseudo`` keeps one kernel
family's rows (forward and backward); ``--match TEXT`` the rows whose shape
label holds TEXT (``--match wide``: the wide path's).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

GRAPH_SECONDS, REPLAYS = 0.05, 3


def table_cases() -> list:
    """chip_smoke's timed cases, then the shape table's shapes with each
    kernel on its own (F 600; the message kernels at S 4, as the table),
    then the pseudo kernels' wide path at the shape table's M 100 and at
    n_rbf 200, each (kernel, shape, cutoff) once."""
    pk = chip_smoke.load_example("profile_kernels_torch")
    table = [(kind, (b, m, 9, r), cut, f"wide table B={b} M={m} n_rbf={r}", True)
             for b, m, r, cut in ((4, 100, chip_smoke.WIDE_RBF, pk.CUTOFF["pseudo"]),
                                  (16, 3, 200, 8.5))
             for kind in ("pseudo", "pseudo_vjp")]
    for base, shapes, s, size in (("pseudo", pk.PSEUDO_SHAPES, 9, "M"),
                                  ("message", pk.MESSAGE_SHAPES, 4, "N")):
        table += [(kind, (b, n, s, pk.N_RBF), pk.CUTOFF[base], f"shape table B={b} {size}={n}",
                   True) for b, n in shapes for kind in (base, base + "_vjp")]
    seen = {c[:3] for c in table}
    return [c for c in chip_smoke.kernel_cases() if c[4] and c[:3] not in seen] + table


def sized_ms(fn) -> float:
    """``graph_ms`` of ``fn`` with as many calls in the graph as make ~50 ms
    (1 to 20), from one timed call after a warm one."""
    import torch

    from coarsegrainingvae_tpu_torch.utils.profiling import graph_ms

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    one = time.perf_counter() - t
    return graph_ms(fn, int(min(20, max(1, GRAPH_SECONDS / max(one, 1e-6)))), REPLAYS)


def compiled_columns(plain, args, ref) -> dict:
    """The plain version under ``torch.compile`` (compiled anew for each
    case, so it never falls back to eager past dynamo's cache limit): its
    ms, its error against the plain version and the compile's seconds."""
    import torch

    from coarsegrainingvae_tpu_torch.utils.profiling import rel_err

    torch._dynamo.reset()
    compiled = torch.compile(plain, dynamic=False)
    t = time.perf_counter()
    comp = compiled(*args)
    torch.cuda.synchronize()
    compile_s = time.perf_counter() - t
    return {"compiled_ms": sized_ms(lambda: compiled(*args)),
            "compiled_rel_err": rel_err(comp, ref)[0], "compile_s": compile_s}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("message", "pseudo"),
                    help="only this kernel family's rows")
    ap.add_argument("--match", default="", help="only the rows whose shape label holds this")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("kernel_table: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = [c for c in table_cases()
             if (args.kernel is None or c[0].startswith(args.kernel)) and args.match in c[3]]
    rows = chip_smoke.check_kernels(cases, sized_ms, compiled_columns)
    for row in rows:
        print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_table.json").write_text(json.dumps(
        {"card": chip_smoke.card_line(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
