#!/usr/bin/env python3
"""Another ``fused_message.cu``'s kernels against the checkout's, on one GPU.

    mkdir -p build/parent
    for f in fused_message.cu pair_geometry.cuh; do
        git show <rev>:coarsegrainingvae_tpu_torch/csrc/$f > build/parent/$f
    done
    python3 scripts/kernel_ab.py --parent build/parent

Builds the other source (any version with a backward: its d_w scratch holds
``fused_message_bwd_tiles(N)`` partials per frame where the library exports
that symbol, one otherwise) and the checkout's with nvcc, checks both
against the plain versions at each shape, then times them in alternating
order (parent, change, change, parent, ...), each run ``--launches``
launches replayed from CUDA graphs (``chip_smoke.cuda_ms``), so host launch
cost stays out of the times. Prints the card, each library's ptxas summary,
one line per (kernel, shape) with every run's ms per launch, and the SM
clock and power read while the change's encoder backward runs; writes the
same to ``chiprun_out/kernel_ab_<parent directory name>.json``. Needs one
CUDA device.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

F, N_RBF, CUTOFF, RTOL = 600, 8, 9.5, chip_smoke.KERNEL_RTOL
PER_GRAPH = 100
# (label, B, N, S): the encoder's and the prior's train shapes, the served
# prior, and the cross variant
SHAPES = [("encoder train", 128, 27, 3), ("prior train", 128, 3, 3),
          ("prior serve", 64, 3, 3), ("cross", 64, 27, 4)]
SYMBOLS = {
    "fused_message_fwd": ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
                          + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
    "fused_message_bwd": ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 5
                          + [ctypes.c_float, ctypes.c_void_p], ctypes.c_int),
}


def build_parent(src: Path):
    """nvcc the other source with the port's flags into
    build/kernel_ab/lib<dir name>.so; (library, ptxas log)."""
    from coarsegrainingvae_tpu_torch.ops import cuda_build

    out = ROOT / "build" / "kernel_ab" / f"lib{src.parent.name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for sym, (argtypes, restype) in SYMBOLS.items():
        getattr(lib, sym).argtypes = argtypes
        getattr(lib, sym).restype = restype
    return lib, res.stderr


def bwd_tiles(lib, n: int) -> int:
    """d_w partials per frame that the library's backward writes."""
    return lib.fused_message_bwd_tiles(n) if hasattr(lib, "fused_message_bwd_tiles") else 1


def inputs(b, n, s, seed):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device="cuda")

    mask = torch.ones(b, n, device="cuda")
    mask[::2, -1] = 0.0
    return dict(xyz=randn(b, n, 3) * 3.0, mask=mask, phi=randn(b, n, s, F),
                v=randn(b, n, 3, F), w=randn(N_RBF + 1, s, F) * 0.3,
                gs=randn(b, n, F), gv=randn(b, n, 3, F))


def launchers(lib, t):
    """(forward, backward) closures that launch one library's kernels on
    preallocated outputs, each with its outputs."""
    import torch

    b, n, s, f = t["phi"].shape
    ra = N_RBF + 1
    ds = torch.empty(b, n, f, device="cuda")
    dv = torch.empty(b, n, 3, f, device="cuda")
    dphi = torch.empty(b, n, s, f, device="cuda")
    dvb = torch.empty(b, n, 3, f, device="cuda")
    part = torch.empty(b * bwd_tiles(lib, n), ra, s, f, device="cuda")
    dw = torch.empty(ra, s, f, device="cuda")
    p = {k: v.data_ptr() for k, v in t.items()}

    def fwd():
        err = lib.fused_message_fwd(p["xyz"], p["mask"], p["phi"], p["v"], p["w"],
                                    ds.data_ptr(), dv.data_ptr(), b, n, s, f, ra, CUTOFF,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward launch failed: {err}")

    def bwd():
        err = lib.fused_message_bwd(p["xyz"], p["mask"], p["phi"], p["v"], p["w"], p["gs"],
                                    p["gv"], dphi.data_ptr(), dvb.data_ptr(), part.data_ptr(),
                                    dw.data_ptr(), b, n, s, f, ra, CUTOFF,
                                    torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward launch failed: {err}")

    fwd.inputs = bwd.inputs = t         # the closures hold raw pointers into t
    return (fwd, (ds, dv)), (bwd, (dphi, dvb, dw))


def clocks_under_load(fn, seconds: float = 3.0) -> str:
    """nvidia-smi's SM clock, power draw and limit read while ``fn`` runs
    back to back for about ``seconds``."""
    import torch

    ms = chip_smoke.cuda_ms(fn, PER_GRAPH, 2)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PER_GRAPH):
            fn()
    for _ in range(int(seconds * 1e3 / (ms * PER_GRAPH)) + 1):
        graph.replay()
    time.sleep(seconds / 2)
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
                          "power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    torch.cuda.synchronize()
    return res


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True,
                    help="directory holding the other fused_message.cu and pair_geometry.cuh")
    ap.add_argument("--pairs", type=int, default=4, help="alternating (parent, change) pairs")
    ap.add_argument("--launches", type=int, default=1000, help="launches per timed run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from coarsegrainingvae_tpu_torch.ops import cuda_build
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo

    card = chip_smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs, logs = {}, {}
    with ThreadPoolExecutor(1) as pool:         # the two nvcc runs together
        parent = pool.submit(build_parent, args.parent.resolve() / "fused_message.cu")
        libs["change"] = mo.build()
        logs["change"] = cuda_build.BUILD_LOG.get("fused_message", "")
        libs["parent"], logs["parent"] = parent.result()
    print(f"build: both libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for side, log in logs.items():
        chip_smoke.print_ptxas(side, log, N_RBF + 1)

    replays = max(1, args.launches // PER_GRAPH)
    rows = []
    for seed, (label, b, n, s) in enumerate(SHAPES):
        t = inputs(b, n, s, seed)
        sides = {side: launchers(libs[side], t) for side in ("parent", "change")}
        plain = {"forward": mo.message_reference(t["xyz"], t["mask"], t["phi"], t["v"], t["w"],
                                                 CUTOFF, N_RBF),
                 "backward": mo.message_vjp_reference(*t.values(), CUTOFF, N_RBF)}
        for k, kernel in enumerate(("forward", "backward")):
            errs = {}
            for side, pair in sides.items():
                fn, outs = pair[k]
                fn()
                torch.cuda.synchronize()
                errs[side] = chip_smoke.rel_err(outs, plain[kernel])[0]
                if not errs[side] <= RTOL:
                    raise RuntimeError(f"{side} {kernel} [{label}] disagrees with plain: "
                                       f"{errs[side]:.3e}")
            runs = {side: [] for side in sides}
            for i in range(args.pairs):         # parent, change, change, parent, ...
                for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                    runs[side].append(chip_smoke.cuda_ms(sides[side][k][0], PER_GRAPH, replays))
            med = {side: statistics.median(v) for side, v in runs.items()}
            row = {"kernel": kernel, "shape": f"{label} B={b} N={n} S={s} F={F} R={N_RBF}",
                   "launches_per_run": PER_GRAPH * replays, "max_rel_err": errs,
                   "ms_runs": runs, "ms_median": med,
                   "speedup": med["parent"] / med["change"]}
            rows.append(row)
            print(f"{kernel} [{row['shape']}]: " + "; ".join(
                f"{side} {med[side]:.4f} ms ({med['parent'] / med[side]:.2f}x; runs "
                f"{', '.join(f'{x:.4f}' for x in runs[side])}; rel err {errs[side]:.2e})"
                for side in sides), flush=True)
        if label == "encoder train":
            load = sides["change"][1][0]
    clocks = clocks_under_load(load)
    print(f"under load (change, encoder backward): {clocks}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"kernel_ab_{args.parent.resolve().name}.json").write_text(json.dumps(
        {"card": card, "parent": str(args.parent), "rows": rows,
         "clocks_under_load": clocks}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
