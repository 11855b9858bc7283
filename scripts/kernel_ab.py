#!/usr/bin/env python3
"""Another version of a kernel library's kernels against the checkout's, on
one GPU.

    mkdir -p build/parent
    for f in fused_message.cu fused_pseudo.cu pair_geometry.cuh; do
        git show <rev>:coarsegrainingvae_tpu_torch/csrc/$f > build/parent/$f
    done
    python3 scripts/kernel_ab.py --parent build/parent                    # fused_message.cu
    python3 scripts/kernel_ab.py --parent build/parent --library pseudo   # fused_pseudo.cu

Builds the other source (any version with a backward: its d_w scratch holds
the partial count that the library exports, ``fused_message_bwd_tiles(N)``
partials per frame or ``fused_pseudo_bwd_partials(B, M)`` in all, where it
exports that symbol, and one per frame otherwise) and the checkout's with
nvcc, checks both against the plain versions at each shape, then times them
in alternating order (parent, change, change, parent, ...), each run
``--launches`` launches replayed from CUDA graphs (``utils.profiling.graph_ms``),
so host launch cost stays out of the times. Prints the card, each library's
ptxas summary, one line per (kernel, shape) with every run's ms per launch,
and the SM clock and power read while the change's backward runs at the
first shape; writes the same to
``chiprun_out/kernel_ab_<library>_<parent directory name>.json``. Needs one
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
from coarsegrainingvae_tpu_torch.utils import profiling  # noqa: E402

F, N_RBF, RTOL = 600, 8, chip_smoke.KERNEL_RTOL
PER_GRAPH = 100
# (label, B, N, S) per library: the message kernels at the encoder's and the
# prior's train shapes, the served prior and the cross variant; the pseudo
# kernels at the decoder's train and serve shapes and at chignolin's M = 6
SHAPES = {
    "message": [("encoder train", 128, 27, 3), ("prior train", 128, 3, 3),
                ("prior serve", 64, 3, 3), ("cross", 64, 27, 4)],
    "pseudo": [("decoder train", 128, 3, 9), ("decoder serve", 64, 3, 9),
               ("decoder M=6", 64, 6, 9)],
}
CUTOFF = {"message": 9.5, "pseudo": 8.5}


def ops(library: str):
    from coarsegrainingvae_tpu_torch.ops import fused_message, fused_pseudo

    return {"message": fused_message, "pseudo": fused_pseudo}[library]


def build_parent(library: str, src: Path):
    """nvcc the other source with the port's flags into
    build/kernel_ab/lib<library>_<dir name>.so; (library, ptxas log)."""
    from coarsegrainingvae_tpu_torch.ops import cuda_build

    out = ROOT / "build" / "kernel_ab" / f"lib{library}_{src.parent.name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
    lib = ctypes.CDLL(str(out))
    for sym, (argtypes, restype) in ops(library)._SYMBOLS.items():
        if hasattr(lib, sym):
            getattr(lib, sym).argtypes = argtypes
            getattr(lib, sym).restype = restype
    return lib, res.stderr


def partials(library: str, lib, b: int, n: int) -> int:
    """d_w partials that the library's backward writes."""
    if library == "message":
        return b * (lib.fused_message_bwd_tiles(n) if hasattr(lib, "fused_message_bwd_tiles") else 1)
    return lib.fused_pseudo_bwd_partials(b, n) if hasattr(lib, "fused_pseudo_bwd_partials") else b


def inputs(library, b, n, s, seed):
    """The kernel's inputs and cotangents, as chip_smoke.kernel_inputs makes
    them, by name."""
    kind = "message_vjp" if library == "message" else "pseudo_vjp"
    t = chip_smoke.kernel_inputs(kind, b, n, s, F, N_RBF, seed)
    names = (["xyz", "mask", "phi", "v", "w", "gs", "gv"] if library == "message" else
             ["xyz", "mask", "phi", "s", "sbar", "v", "vbar", "w", "gs", "gsb", "gv", "gvb"])
    return dict(zip(names, t))


def launchers(library, lib, t):
    """(forward, backward) closures that launch one library's kernels on
    preallocated outputs, each with its outputs."""
    import torch

    b, n, s, f = t["phi"].shape
    ra, cut = N_RBF + 1, CUTOFF[library]
    p = {k: v.data_ptr() for k, v in t.items()}

    def empty_like(*names):
        return [torch.empty_like(t[k]) for k in names]

    if library == "message":
        fwd_in, fwd_out = ("xyz", "mask", "phi", "v", "w"), empty_like("gs", "gv")
        bwd_in, bwd_out = tuple(t), empty_like("phi", "v")
        fwd_fn, bwd_fn, shape = lib.fused_message_fwd, lib.fused_message_bwd, (b, n, s, f)
    else:
        fwd_in = ("xyz", "mask", "phi", "s", "sbar", "v", "vbar", "w")
        fwd_out = empty_like("s", "sbar", "v", "vbar")
        bwd_in, bwd_out = tuple(t), empty_like("phi", "s", "sbar", "v", "vbar")
        fwd_fn, bwd_fn, shape = lib.fused_pseudo_fwd, lib.fused_pseudo_bwd, (b, n, f)
    part = torch.empty(partials(library, lib, b, n), ra, s, f, device="cuda")
    dw = torch.empty(ra, s, f, device="cuda")

    def fwd():
        err = fwd_fn(*(p[k] for k in fwd_in), *(o.data_ptr() for o in fwd_out), *shape, ra, cut,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"forward launch failed: {err}")

    def bwd():
        err = bwd_fn(*(p[k] for k in bwd_in), *(o.data_ptr() for o in bwd_out),
                     part.data_ptr(), dw.data_ptr(), *shape, ra, cut,
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"backward launch failed: {err}")

    fwd.inputs = bwd.inputs = t         # the closures hold raw pointers into t
    return (fwd, tuple(fwd_out)), (bwd, tuple(bwd_out) + (dw,))


def plain(library, t):
    """The plain versions' outputs, forward and backward."""
    mod, cut = ops(library), CUTOFF[library]
    if library == "message":
        fwd = mod.message_reference(t["xyz"], t["mask"], t["phi"], t["v"], t["w"], cut, N_RBF)
        return {"forward": fwd, "backward": mod.message_vjp_reference(*t.values(), cut, N_RBF)}
    fwd = mod.pseudo_reference(*list(t.values())[:8], cut, N_RBF)
    return {"forward": fwd, "backward": mod.pseudo_vjp_reference(*t.values(), cut, N_RBF)}


def clocks_under_load(fn, seconds: float = 3.0) -> str:
    """nvidia-smi's SM clock, power draw and limit read while ``fn`` runs
    back to back for about ``seconds``."""
    import torch

    ms = profiling.graph_ms(fn, PER_GRAPH, 2)
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
                    help="directory holding the other library source and pair_geometry.cuh")
    ap.add_argument("--library", choices=sorted(SHAPES), default="message",
                    help="message: fused_message.cu; pseudo: fused_pseudo.cu")
    ap.add_argument("--pairs", type=int, default=4, help="alternating (parent, change) pairs")
    ap.add_argument("--launches", type=int, default=1000, help="launches per timed run")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from coarsegrainingvae_tpu_torch.ops import cuda_build

    library, name = args.library, f"fused_{args.library}"
    card = chip_smoke.card_line()
    print(card, flush=True)
    t0 = time.perf_counter()
    libs, logs = {}, {}
    with ThreadPoolExecutor(1) as pool:         # the two nvcc runs together
        parent = pool.submit(build_parent, library, args.parent.resolve() / f"{name}.cu")
        libs["change"] = ops(library).build()
        logs["change"] = cuda_build.BUILD_LOG.get(name, "")
        libs["parent"], logs["parent"] = parent.result()
    print(f"build: both libraries in {time.perf_counter() - t0:.2f} s", flush=True)
    for side, log in logs.items():
        chip_smoke.print_ptxas(side, log, N_RBF + 1)

    replays = max(1, args.launches // PER_GRAPH)
    rows, load = [], None
    for seed, (label, b, n, s) in enumerate(SHAPES[library]):
        t = inputs(library, b, n, s, seed)
        sides = {side: launchers(library, libs[side], t) for side in ("parent", "change")}
        want = plain(library, t)
        for k, kernel in enumerate(("forward", "backward")):
            errs = {}
            for side, pair in sides.items():
                fn, outs = pair[k]
                fn()
                torch.cuda.synchronize()
                errs[side] = profiling.rel_err(outs, want[kernel])[0]
                if not errs[side] <= RTOL:
                    raise RuntimeError(f"{side} {kernel} [{label}] disagrees with plain: "
                                       f"{errs[side]:.3e}")
            runs = {side: [] for side in sides}
            for i in range(args.pairs):         # parent, change, change, parent, ...
                for side in (("parent", "change") if i % 2 == 0 else ("change", "parent")):
                    runs[side].append(profiling.graph_ms(sides[side][k][0], PER_GRAPH, replays))
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
        if load is None:
            load = sides["change"][1][0]
    clocks = clocks_under_load(load)
    print(f"under load (change, {SHAPES[library][0][0]} backward): {clocks}", flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / f"kernel_ab_{library}_{args.parent.resolve().name}.json").write_text(json.dumps(
        {"card": card, "library": library, "parent": str(args.parent), "rows": rows,
         "clocks_under_load": clocks}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
