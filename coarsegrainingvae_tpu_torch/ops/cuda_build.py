"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and may include the shared
headers ``csrc/*.cuh``. On first use it is compiled with ``nvcc`` for Hopper
(``sm_90a``) into ``build/kernels/`` at the root of the checkout, under a file
name that carries the hash of the source and the headers, so an edited
source is rebuilt and a stale library is never loaded. The library is loaded
with ``ctypes``. Nothing here runs at import time, and there is no fallback:
a missing ``nvcc`` or a failed build raises. Each build is recorded as the
span ``ops.build.<name>`` (``utils.tracing``; ``tracing.seconds("ops.build.")``
gives the seconds by source) and its compiler output kept in ``BUILD_LOG``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Tuple

import torch

from coarsegrainingvae_tpu_torch.utils import tracing

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# loaded libraries and each build's compiler output, per process
_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and PATH); the CUDA "
            "kernels of coarsegrainingvae_tpu_torch are built from source"
        )
    return found


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source and every shared
    header in ``csrc/``, so an edit to either means a rebuild."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str, symbols: Dict[str, Tuple[List, object]]) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; declare each symbol's
    ``argtypes`` and ``restype`` from ``symbols``."""
    if name in _LIBS:
        return _LIBS[name]
    out = library_path(name)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        with tracing.span(f"ops.build.{name}"):
            res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed building {name}.cu:\n{res.stdout}\n{res.stderr}"
            )
        os.replace(tmp, out)
        BUILD_LOG[name] = res.stderr
    lib = ctypes.CDLL(str(out))
    for sym, (argtypes, restype) in symbols.items():
        fn = getattr(lib, sym)
        fn.argtypes = argtypes
        fn.restype = restype
    _LIBS[name] = lib
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")


def check_inputs(tensors: Dict[str, torch.Tensor], device: torch.device) -> None:
    """Every kernel reads float32, contiguous tensors on one device."""
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
