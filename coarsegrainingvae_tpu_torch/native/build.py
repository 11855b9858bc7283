"""Build and load the port's host C++ (``native/*.cpp``).

A source is compiled on first use with g++ into ``build/native/`` at the
root of the checkout, under a name that carries the hash of the source and
the flags, so an edited source is rebuilt and a stale library is never
loaded. The flags are the JAX package's, so that the distance comparisons
round alike. Each build writes a temporary file and renames it into place:
processes that build at the same moment each load a whole library. There
is no fallback: a missing or failing g++ raises ``BuildError`` with the
compiler's output. Each build is recorded as the span ``native.build.<name>``
(``utils.tracing``; ``tracing.seconds("native.build.")`` gives the seconds
by source).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

from coarsegrainingvae_tpu_torch.utils import tracing

_HERE = Path(__file__).resolve().parent
BUILD_DIR = _HERE.parents[1] / "build" / "native"
GXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


class BuildError(RuntimeError):
    pass


def library_path(name: str) -> Path:
    """``build/native/lib<name>_<hash>.so``; the hash covers the source and
    the flags."""
    h = hashlib.sha256((_HERE / f"{name}.cpp").read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def load(name: str, symbols: Dict[str, Tuple[List, object]]) -> ctypes.CDLL:
    """Build ``native/<name>.cpp`` if its library is missing, then load it
    once per process and declare each symbol's ``argtypes`` and ``restype``
    from ``symbols``."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        out = library_path(name)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
            cmd = ["g++", *GXX_FLAGS, str(_HERE / f"{name}.cpp"), "-o", str(tmp)]
            try:
                with tracing.span(f"native.build.{name}"):
                    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            except (OSError, subprocess.TimeoutExpired) as e:
                raise BuildError(f"g++ could not build {name}.cpp: {e}") from e
            if res.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise BuildError(f"g++ failed building {name}.cpp:\n{res.stdout}\n{res.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        for sym, (argtypes, restype) in symbols.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = restype
        _LIBS[name] = lib
        return lib
