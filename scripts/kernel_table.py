#!/usr/bin/env python3
"""The kernel table on one GPU: each kernel against its plain version at
every shape ``chip_smoke.py`` times, and kernel by kernel at the shapes of
the kernel shape table (``examples/profile_kernels_torch.py``).

    python3 scripts/kernel_table.py

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
of JAX.
"""
from __future__ import annotations

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
    kernel on its own (F 600; the message kernels at S 4, as the table)."""
    pk = chip_smoke.load_example("profile_kernels_torch")
    cases = [c for c in chip_smoke.kernel_cases() if c[4]]
    for base, shapes, s, size in (("pseudo", pk.PSEUDO_SHAPES, 9, "M"),
                                  ("message", pk.MESSAGE_SHAPES, 4, "N")):
        cases += [(kind, (b, n, s, pk.N_RBF), pk.CUTOFF[base], f"shape table B={b} {size}={n}",
                   True) for b, n in shapes for kind in (base, base + "_vjp")]
    return cases


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
    import torch

    if not torch.cuda.is_available():
        print("kernel_table: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke.card_line(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = chip_smoke.check_kernels(table_cases(), sized_ms, compiled_columns)
    for row in rows:
        print(json.dumps(row), flush=True)
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "kernel_table.json").write_text(json.dumps(
        {"card": chip_smoke.card_line(), "rows": rows}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
