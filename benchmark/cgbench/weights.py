"""Weights from ``--seed``, drawn on the device in one call.

Every leaf's initial scale follows the port's initialisers (commit
add70c80, ``models/modules.py``, ``models/dense.py::factored_filter``):
a Dense weight is Xavier-uniform, a bias zero, an embedding table has unit
variance, a factored filter is Xavier-uniform over (R -> S F) with its bias
row zero. The rule reads the reference model's modules, and the port's
model takes the same values by parameter name.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from cgbench.reference.layers import Dense, EmbeddingZeroPad

# (name, shape, bound of the uniform draw, zero the last row)
Leaf = Tuple[str, Tuple[int, ...], float, bool]


def leaves(model: torch.nn.Module) -> List[Leaf]:
    """The initialisation of every parameter of a reference model."""
    out = []
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            name = f"{mod_name}.{p_name}" if mod_name else p_name
            shape = tuple(p.shape)
            if isinstance(mod, Dense):
                bound = 0.0 if p_name == "bias" else math.sqrt(6.0 / (shape[0] + shape[1]))
                out.append((name, shape, bound, False))
            elif isinstance(mod, EmbeddingZeroPad):
                out.append((name, shape, math.sqrt(3.0), False))
            elif p_name == "filter_w":
                r, s, f = shape[0] - 1, shape[1], shape[2]
                out.append((name, shape, math.sqrt(6.0 / (r + s * f)), True))
            else:
                raise ValueError(f"no initialiser for parameter {name} of {type(mod).__name__}")
    return out


def draw(spec: List[Leaf], seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> float32 tensor on ``device``: one uniform draw from a
    generator on the device, scaled per leaf."""
    sizes = [math.prod(shape) for _, shape, _, _ in spec]
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.uniform_(-1.0, 1.0, generator=gen)
    bounds = torch.tensor([b for _, _, b, _ in spec], dtype=torch.float32, device=device)
    flat.mul_(torch.repeat_interleave(bounds, torch.tensor(sizes, device=device)))
    out = {}
    for (name, shape, _, zero_last), part in zip(spec, torch.split(flat, sizes)):
        t = part.view(shape)
        if zero_last:
            t[-1].zero_()
        out[name] = t
    return out


def load(model: torch.nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """Copy ``weights`` into ``model``'s parameters by name, in each
    parameter's own dtype; every parameter must have one of the same shape."""
    params = dict(model.named_parameters())
    if sorted(params) != sorted(weights):
        missing = sorted(set(params) ^ set(weights))
        raise ValueError(f"parameters and weights differ: {missing[:8]}")
    with torch.no_grad():
        for name, p in params.items():
            if tuple(p.shape) != tuple(weights[name].shape):
                raise ValueError(f"{name}: shape {tuple(p.shape)}, weight "
                                 f"{tuple(weights[name].shape)}")
            p.copy_(weights[name])
