"""Derived random streams: the torch stand-in for ``jax.random.fold_in``.

A JAX key is split by folding integers into it; here a seed and a tuple of
integers go through numpy's ``SeedSequence`` to one 32-bit seed, and a
``torch.Generator`` on the target device starts from it. Equal tuples give
equal streams; the streams are not JAX's.
"""
from __future__ import annotations

from typing import Union

import numpy as np
import torch


def fold_in(seed: int, *data: int) -> int:
    """A seed derived from ``(seed, *data)``, all non-negative integers."""
    return int(np.random.SeedSequence([int(seed), *map(int, data)]).generate_state(1)[0])


def generator(device: Union[str, torch.device], seed: int, *data: int) -> torch.Generator:
    """A generator on ``device`` seeded from ``(seed, *data)``."""
    return torch.Generator(device=device).manual_seed(fold_in(seed, *data))
