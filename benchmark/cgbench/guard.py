"""The check that nothing the benchmark runs loaded JAX or the JAX package.

Module names are compared by their top-level name as a whole string: the
port, ``coarsegrainingvae_tpu_torch``, begins with the JAX package's name
and is not the JAX package.
"""
from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "coarsegrainingvae_tpu"})


def forbidden_loaded(modules: Iterable[str] = None) -> List[str]:
    """The forbidden top-level names among ``modules`` (``sys.modules``)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & FORBIDDEN)
