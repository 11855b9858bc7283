"""The comparison that decides ``correct``.

Both sides give ``readings``: each checked step's loss, and per leaf the
norm of the first clipped gradient as Adam's first moment holds it after
step 1 (m / (1 - b1)), and of the parameters' change after the last
checked step. Three numbers follow, each a gap of the program from the
reference:

- ``loss_gap``: the largest |loss - loss_ref| / |loss_ref| over the steps;
- ``grad_gap``: the worst leaf's |norm - norm_ref| over the larger of its
  reference norm and the median leaf's;
- ``change_gap``: the same for the parameters' change, over the leaves
  whose reference gradient is at least a thousandth of the median leaf's
  (a leaf with a gradient at rounding's level moves under Adam by rounding
  alone).
"""
from __future__ import annotations

from typing import Dict

import torch

NUMBERS = ("loss_gap", "grad_gap", "change_gap")
RULE = 1e-3      # a leaf's gradient under this share of the median leaf's is left out


def _worst_leaf(norms: torch.Tensor, ref: torch.Tensor) -> float:
    scale = torch.clamp(ref, min=float(torch.median(ref)))
    return float(torch.max(torch.abs(norms - ref) / scale))


def numbers(prog: dict, ref: dict) -> Dict[str, float]:
    """The three gaps of ``prog``'s readings from ``ref``'s (leaves matched
    by name)."""
    order = [prog["names"].index(n) for n in ref["names"]]

    def take(key):
        return prog[key].double().cpu()[order]

    grad_ref = ref["grad_norms"].double().cpu()
    exact = ref["exact_grad_norms"].double().cpu()
    keep = exact >= RULE * torch.median(exact)
    change_ref = ref["change_norms"].double().cpu()
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    return {"loss_gap": float(loss),
            "grad_gap": _worst_leaf(take("grad_norms"), grad_ref),
            "change_gap": _worst_leaf(take("change_norms")[keep], change_ref[keep])}


def own_scale(prog: dict, ref: dict) -> Dict[str, object]:
    """Not compared, read by ``calibrate.py``: over the leaves that the
    median's floor scales (reference norm under the median leaf's) and that
    the rule keeps, the worst gap over the leaf's own reference norm, of
    the first gradient and of the change, with the leaf's name."""
    order = [prog["names"].index(n) for n in ref["names"]]
    exact = ref["exact_grad_norms"].double().cpu()
    keep = exact >= RULE * torch.median(exact)
    out: Dict[str, object] = {}
    for key, name in (("grad_norms", "grad"), ("change_norms", "change")):
        r = ref[key].double().cpu()
        p = prog[key].double().cpu()[order]
        small = keep & (r < torch.median(r))
        gaps = torch.where(small, torch.abs(p - r) / r.clamp_min(1e-300), torch.zeros_like(r))
        worst = int(torch.argmax(gaps))
        out[f"{name}_gap_own"] = float(gaps[worst])
        out[f"{name}_gap_own_leaf"] = ref["names"][worst]
    return out


def judge(values: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Whether every number lies within its limit (a NaN does not)."""
    return all(values[k] <= limits[k] for k in NUMBERS)
