"""Segment reductions (port of ``coarsegrainingvae_tpu.ops.segment``).

The sparse model sums per-edge messages into their receivers. On a CUDA
device ``index_add_`` and ``scatter_add_`` accumulate floats with atomics,
so their sums change with the order the threads arrive in, and a captured
epoch would no longer equal an eager one bit for bit. Here every sum is a
CSR reduction instead: the segment ids are sorted, the segments' offsets
come from ``searchsorted`` on them, and ``torch.segment_reduce`` adds each
segment's rows in order. The result has the same bits on every call and
every replay, needs no host synchronisation, and has a static shape.

Receiver ids arrive sorted: the data pipeline emits receiver-sorted edge
lists padded at the tail with ``(n-1, n-1)`` self-loops
(``data/neighbors.py``), and ``flatten_ids`` keeps the order across the
batch. Pass ``indices_are_sorted=True`` only for ids that are sorted;
other ids (a CG mapping) are put in order by a stable argsort first.
"""
from __future__ import annotations

from typing import Optional

import torch


def _mask_rows(data: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(data.dtype)
    return data * m.reshape(m.shape + (1,) * (data.ndim - m.ndim))


def segment_sum(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """scatter_add equivalent: out[k] = sum of data[e] over segment_ids[e]
    == k, masked rows contributing zero; (num_segments, ...) in data's
    dtype. Deterministic; see the module docstring."""
    if mask is not None:
        data = _mask_rows(data, mask)
    if not indices_are_sorted:
        order = torch.argsort(segment_ids, stable=True)
        segment_ids, data = segment_ids[order], data[order]
    bounds = torch.arange(num_segments + 1, dtype=segment_ids.dtype,
                          device=segment_ids.device)
    offsets = torch.searchsorted(segment_ids.contiguous(), bounds)
    return torch.segment_reduce(data, "sum", offsets=offsets, axis=0, unsafe=True)


def segment_mean(
    data: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
    eps: float = 1e-12,
    indices_are_sorted: bool = False,
) -> torch.Tensor:
    """scatter_mean equivalent; empty segments give 0 rather than NaN."""
    total = segment_sum(data, segment_ids, num_segments, mask, indices_are_sorted)
    if mask is not None:
        ones = mask.to(data.dtype)
    else:
        ones = torch.ones(segment_ids.shape, dtype=data.dtype, device=data.device)
    counts = segment_sum(ones, segment_ids, num_segments,
                         indices_are_sorted=indices_are_sorted)
    counts = counts.reshape(counts.shape + (1,) * (data.ndim - 1))
    return total / torch.clamp(counts, min=eps)


def segment_softmax(
    logits: torch.Tensor,
    segment_ids: torch.Tensor,
    num_segments: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Per-segment softmax over rows of ``logits`` (E,), stable by the
    segment's max; masked rows get 0, and a segment with no unmasked row
    gives 0 rather than NaN. The max is a scatter-reduce, which gives the
    same result in any order; the sum goes through ``segment_sum``. Not on
    the original code's live path (its attention is commented out,
    conv.py:536-551); the JAX package keeps it in its op library."""
    neg_inf = torch.full_like(logits, float("-inf"))
    if mask is not None:
        logits = torch.where(mask, logits, neg_inf)
    maxes = torch.full((num_segments,), float("-inf"), dtype=logits.dtype,
                       device=logits.device).scatter_reduce(0, segment_ids, logits, "amax")
    maxes = torch.where(torch.isfinite(maxes), maxes, torch.zeros_like(maxes))
    exp = torch.exp(logits - maxes[segment_ids])
    if mask is not None:
        exp = torch.where(mask, exp, torch.zeros_like(exp))
    denom = segment_sum(exp, segment_ids, num_segments)
    return exp / torch.clamp(denom[segment_ids], min=1e-12)
