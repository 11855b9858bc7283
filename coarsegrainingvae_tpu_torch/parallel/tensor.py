"""Tensor parallelism over the model axis of a ('data', 'model') mesh (port
of the JAX package's ``tensor_shardings`` and of what XLA's partitioner
makes of it).

The partition of the state. The JAX package splits every parameter and
Adam-moment leaf whose LAST dimension is at least 128 and divides by the
model axis column-wise over that axis; every other leaf replicates
(``coarsegrainingvae_tpu/parallel/mesh.py::tensor_shardings``). A port
tensor is sharded exactly when its flax leaf is: ``convert.tensor_layouts``
views each one as (A, L, C), L the last dimension of its flax leaves (a
``Dense`` weight (out, in) as (1, out, in); a copied leaf such as
``filter_w`` (R+1, S, F) as ((R+1) S, F, 1); the pseudo block's filter
from the default tree's DistanceEmbed kernel (R, 9F) and bias (9F,) as
(R+1, 9F, 1)), and model rank r holds [:, r*L/m:(r+1)*L/m, :] of it and of
its two moments (``TensorLayout``).

The compute split (``FeatureSplit``). The dense model's message blocks
compute per feature: the outputs at feature f of kernels 1-4 read only
feature f of phi, of the node features and of the filter w (R+1, S, F).
So under a feature split each model rank runs its block's kernel on its
F/m features (phi_out's columns of its slice in each channel, its slice
of v, s, sbar, vbar and of filter_w) and all-gathers the outputs along F.
Backward, the slice's gradients land in its columns of phi_out and
filter_w, the gathered outputs' cotangent is cut back to the slice, the
node features' slice cotangents are all-gathered, and the input gradient
of the column-split phi_out is all-reduced over the model group. Every
other module computes on the gathered weights, replicated on the group.

Each collective here is an autograd Function over ``parallel.mesh``'s
collectives, so on NCCL it is captured in the epoch's CUDA graph with the
rest of the step.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import torch

from coarsegrainingvae_tpu_torch.parallel.mesh import Mesh, all_gather_, all_reduce_

# the JAX package's min_dim: narrower leaves replicate
MIN_DIM = 128

Layout = Tuple[int, int, int]        # (A, L, C): the tensor viewed as (A, L, C)


def tensor_shardings(layouts: Mapping[str, Layout], model_devices: int,
                     min_dim: int = MIN_DIM) -> Dict[str, bool]:
    """Which port tensors the model axis shards: those whose flax leaves'
    last dimension L is at least ``min_dim`` and divides by
    ``model_devices`` (``convert.tensor_layouts`` gives L)."""
    return {name: model_devices > 1 and lay[1] >= min_dim and lay[1] % model_devices == 0
            for name, lay in layouts.items()}


def _gather_last(part: torch.Tensor, axis: Mesh) -> torch.Tensor:
    """(..., k) on each rank -> (..., m*k): every rank's part along the
    last dimension, in rank order."""
    part = part.contiguous()
    out = torch.empty((axis.size * part.numel(),), dtype=part.dtype, device=part.device)
    out = all_gather_(out, part.reshape(-1), axis).view((axis.size,) + tuple(part.shape))
    return out.movedim(0, -2).reshape(part.shape[:-1] + (axis.size * part.shape[-1],))


class _Copy(torch.autograd.Function):
    """Identity forward; the cotangent all-reduced over the model group
    backward (the input of a column-split layer)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.axis), None


class _Slice(torch.autograd.Function):
    """This rank's features [lo, hi) of the last dimension, contiguous;
    backward the slices' cotangents all-gathered into the whole width."""

    @staticmethod
    def forward(ctx, x, axis, lo, hi):
        ctx.axis = axis
        return x[..., lo:hi].contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather_last(g, ctx.axis), None, None, None


class _Gather(torch.autograd.Function):
    """Every rank's features along the last dimension; backward this
    rank's slice of the cotangent (every rank computes the same cotangent
    of the gathered tensor)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.k = axis, x.shape[-1]
        return _gather_last(x, axis)

    @staticmethod
    def backward(ctx, g):
        lo = ctx.axis.rank * ctx.k
        return g[..., lo:lo + ctx.k].contiguous(), None


@dataclass(frozen=True)
class FeatureSplit:
    """Model rank ``axis.rank`` of ``axis.size`` computing features
    [lo, hi) of a block of width ``features``. With no group on ``axis``
    (a test walking the slices in one process) ``copy`` and ``slice`` are
    plain and nothing is gathered."""

    axis: Mesh
    features: int

    @property
    def lo(self) -> int:
        return self.axis.rank * self.features // self.axis.size

    @property
    def hi(self) -> int:
        return (self.axis.rank + 1) * self.features // self.axis.size

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.axis.group is None else _Copy.apply(x, self.axis)

    def slice(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's features of ``x`` (..., F), contiguous: once per
        layer, so the kernels read raw pointers of dense slices."""
        if self.axis.group is None:
            return x[..., self.lo:self.hi].contiguous()
        return _Slice.apply(x, self.axis, self.lo, self.hi)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        return _Gather.apply(x, self.axis)

    def filter(self, w: torch.Tensor) -> torch.Tensor:
        """This rank's features of a filter (R+1, S, F), contiguous; its
        gradient lands in those columns of the parameter."""
        return w[..., self.lo:self.hi].contiguous()

    def columns(self, dense, x: torch.Tensor, n_split: int) -> torch.Tensor:
        """The column-split ``modules.Dense`` (n_split * F outputs, no
        activation): this rank's F/m columns of each of the n_split
        channels, (..., n_split, F/m), in the Dense's cast policy."""
        f = self.features
        w = dense.weight.view(n_split, f, -1)[:, self.lo:self.hi].reshape(-1, dense.weight.shape[1])
        y = x.to(dense.dtype) @ w.to(dense.dtype).T
        if dense.bias is not None:
            y = y + dense.bias.view(n_split, f)[:, self.lo:self.hi].reshape(-1).to(dense.dtype)
        return y.reshape(x.shape[:-1] + (n_split, self.hi - self.lo))


def split_messages(model: torch.nn.Module, axis: Mesh) -> List[str]:
    """Put the feature split of model rank ``axis.rank`` on every message
    block of ``model`` that runs a kernel (``DenseFactoredEquiMessage``,
    ``DenseEquiMessagePseudo``) whose width divides by the model axis.
    Returns the names of the parameters whose gradients are then partial
    on each rank (the blocks' phi_out and filter_w): the trainer sums them
    over the model group."""
    partial = []
    for name, module in model.named_modules():
        if not hasattr(module, "feature_split"):
            continue
        if axis.size > 1 and module.feat_dim % axis.size == 0:
            module.feature_split = FeatureSplit(axis, module.feat_dim)
            partial += [f"{name}.{p}" for p in ("phi_out.weight", "phi_out.bias", "filter_w")]
        else:
            module.feature_split = None
    return partial


class TensorLayout:
    """This model rank's part of the parameters' optimizer view: the flat
    local vector holds, in parameter order, every replicated tensor whole
    and this rank's shard of every sharded one. ``local`` cuts a rank's
    part from whole tensors, ``expand`` gathers local updates back into
    whole ones over the model group, ``full`` / ``own`` move flat moments
    between the local and the one-process form."""

    def __init__(self, named: Sequence[Tuple[str, torch.Size]], layouts: Mapping[str, Layout],
                 axis: Mesh, min_dim: int = MIN_DIM):
        self.axis = axis
        sharded = tensor_shardings(layouts, axis.size, min_dim)
        self.names = [n for n, _ in named]
        self.shapes = [torch.Size(s) for _, s in named]
        self.specs: List[Optional[Layout]] = [layouts[n] if sharded[n] else None
                                              for n in self.names]
        self.sizes = [s.numel() if spec is None else s.numel() // axis.size
                      for s, spec in zip(self.shapes, self.specs)]
        self.numel = sum(self.sizes)

    def _shard(self, t: torch.Tensor, spec: Layout) -> torch.Tensor:
        a, n, c = spec
        k = n // self.axis.size
        r = self.axis.rank
        return t.reshape(a, n, c)[:, r * k:(r + 1) * k].reshape(-1)

    def local(self, tensors: Sequence[torch.Tensor]) -> torch.Tensor:
        """The flat local vector of whole ``tensors`` (one per parameter,
        in order), in their promoted dtype."""
        return torch.cat([t.reshape(-1) if spec is None else self._shard(t, spec)
                          for t, spec in zip(tensors, self.specs)])

    def split(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """A flat local vector -> one flat part per parameter."""
        return list(torch.split(flat, self.sizes))

    def sq_norm(self, flat: torch.Tensor) -> torch.Tensor:
        """sum(g^2) over the whole gradient, from this rank's local flat
        vector: the replicated part counted once, the shards' part summed
        over the model group."""
        parts = self.split(flat)
        rep = [p for p, spec in zip(parts, self.specs) if spec is None]
        shard = [p for p, spec in zip(parts, self.specs) if spec is not None]
        total = torch.zeros((), dtype=flat.dtype, device=flat.device)
        if rep:
            r = torch.cat(rep)
            total = total + torch.sum(r * r)
        if shard:
            s = torch.cat(shard)
            total = total + all_reduce_(torch.sum(s * s).reshape(1), self.axis)[0]
        return total

    def expand(self, flat: torch.Tensor) -> List[torch.Tensor]:
        """Whole tensors (each parameter's shape) from a local flat vector:
        the shards of every rank all-gathered over the model group, in one
        collective."""
        parts = self.split(flat)
        out: List[Optional[torch.Tensor]] = [
            p.view(s) if spec is None else None
            for p, s, spec in zip(parts, self.shapes, self.specs)]
        shard = [p for p, spec in zip(parts, self.specs) if spec is not None]
        if not shard:
            return out
        m = self.axis.size
        mine = torch.cat(shard)
        every = torch.empty((m * mine.numel(),), dtype=mine.dtype, device=mine.device)
        every = all_gather_(every, mine, self.axis).view(m, -1)
        at = 0
        for i, spec in enumerate(self.specs):
            if spec is None:
                continue
            a, n, c = spec
            k = self.sizes[i]
            piece = every[:, at:at + k].reshape(m, a, n // m, c)
            out[i] = piece.transpose(0, 1).reshape(self.shapes[i])
            at += k
        return out

    def full(self, flat: torch.Tensor) -> torch.Tensor:
        """The one-process flat vector (every parameter whole, in order) of
        a local one: a collective."""
        return torch.cat([t.reshape(-1) for t in self.expand(flat)])

    def own(self, full: torch.Tensor) -> torch.Tensor:
        """The inverse of ``full``: this rank's local vector."""
        parts = torch.split(full, [s.numel() for s in self.shapes])
        return self.local([p.view(s) for p, s in zip(parts, self.shapes)])
