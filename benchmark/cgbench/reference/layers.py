"""Plain PyTorch building blocks of the reference.

A frozen copy of the port's plain code at commit add70c80 (``ops/basis.py``,
``ops/activations.py``, ``ops/geometry.py``, ``models/modules.py``,
``models/conv.py::UpdateBlock``/``cross3``, ``models/dense.py::
factored_filter``), with two changes: segment sums are ``index_add``
(plain, not the port's CSR reduction), and every ``Dense`` carries a
``quant`` hook that the lower-precision control sets (``set_precision``).
Imports nothing of the port.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
from torch import nn

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
EPS_DENSE = 1e-3        # the dense family's distance epsilon


def dtype_of(name: str) -> torch.dtype:
    return _DTYPES[name]


def swish(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


ACTIVATIONS = {"swish": swish, "Tanh": torch.tanh, "tanh": torch.tanh,
               "ReLU": torch.relu, "relu": torch.relu, "linear": lambda x: x}


def cosine_envelope(d: torch.Tensor, cutoff: float) -> torch.Tensor:
    out = 0.5 * (torch.cos(math.pi * d / cutoff) + 1.0)
    return torch.where(d >= cutoff, torch.zeros_like(out), out)


def painn_radial_basis(d: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """sin(n pi d / c) / d for n = 1..n_rbf; the sinc limit at d = 0, 0 past c."""
    shape_d = d[..., None]
    n = torch.arange(1, n_rbf + 1, device=d.device).to(d.dtype)
    coef = n * math.pi / cutoff
    zero = shape_d == 0.0
    denom = torch.where(zero, torch.ones_like(shape_d), shape_d)
    num = torch.where(zero, coef, torch.sin(coef * shape_d))
    out = num / denom
    return torch.where(shape_d >= cutoff, torch.zeros_like(out), out)


def preprocess_r(r_ij: torch.Tensor, eps: float = 1e-8) -> Tuple[torch.Tensor, torch.Tensor]:
    dist = torch.sqrt(torch.sum(r_ij**2 + eps, dim=-1))
    return dist, r_ij / dist[..., None]


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the length-3 axis of (E, 3, F) tensors."""
    a1, a2, a3 = a[:, 0], a[:, 1], a[:, 2]
    b1, b2, b3 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack([a2 * b3 - a3 * b2, a3 * b1 - a1 * b3, a1 * b2 - a2 * b1], dim=1)


def segment_sum(data: torch.Tensor, ids: torch.Tensor, n: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    if mask is not None:
        m = mask.to(data.dtype)
        data = data * m.reshape(m.shape + (1,) * (data.ndim - m.ndim))
    out = torch.zeros((n,) + tuple(data.shape[1:]), dtype=data.dtype, device=data.device)
    return out.index_add_(0, ids, data)


def segment_mean(data: torch.Tensor, ids: torch.Tensor, n: int,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    total = segment_sum(data, ids, n, mask)
    ones = (mask.to(data.dtype) if mask is not None
            else torch.ones(ids.shape, dtype=data.dtype, device=data.device))
    counts = segment_sum(ones, ids, n)
    return total / torch.clamp(counts.reshape(counts.shape + (1,) * (data.ndim - 1)), min=1e-12)


class Dense(nn.Module):
    """x @ W.T + b with input, weight and bias cast to the compute dtype
    (flax's cast policy), the activation on the result. ``quant``, when
    set, rounds both operands of the product to a lower precision first."""

    def __init__(self, in_features: int, out_features: int, use_bias: bool = True,
                 activation: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(out_features, in_features))
        self.bias = nn.Parameter(torch.empty(out_features)) if use_bias else None
        self.activation = None if activation in (None, "linear") else ACTIVATIONS[activation]
        self.dtype = dtype
        self.quant = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a, w = x.to(self.dtype), self.weight.to(self.dtype)
        if self.quant is not None:
            a, w = self.quant(a), self.quant(w)
        y = a @ w.T
        if self.bias is not None:
            y = y + self.bias.to(self.dtype)
        if self.activation is not None:
            y = self.activation(y)
        return y


class MLP(nn.Module):
    def __init__(self, in_features: int, features: Sequence[int], activation: str = "ReLU",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        layers = []
        for i, f in enumerate(features):
            last = i == len(features) - 1
            layers.append(Dense(in_features, f, activation=None if last else activation,
                                dtype=dtype))
            in_features = f
        self.layers = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class DistanceEmbed(nn.Module):
    def __init__(self, n_rbf: int, cutoff: float, feat_dim: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_rbf, self.cutoff = n_rbf, cutoff
        self.dense = Dense(n_rbf, feat_dim, dtype=dtype)

    def forward(self, dist: torch.Tensor) -> torch.Tensor:
        feats = self.dense(painn_radial_basis(dist, self.n_rbf, self.cutoff))
        return feats * cosine_envelope(dist, self.cutoff)[..., None]


class EmbeddingZeroPad(nn.Module):
    """Embedding table whose id 0 maps to zero (by a multiply, as the port)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(num_embeddings, features))

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        emb = self.weight[ids]
        return emb * (ids != 0).to(emb.dtype)[..., None]


def factored_filter(n_rbf: int, n_split: int, f: int, dtype: torch.dtype) -> nn.Parameter:
    """(R+1, S, F) filter weights, the last (bias) row zero at the start."""
    return nn.Parameter(torch.empty(n_rbf + 1, n_split, f, dtype=dtype))


class UpdateBlock(nn.Module):
    """PaiNN node update: U, V channel mixing of v gated by an MLP of [s, |Vv|]."""

    def __init__(self, feat_dim: int, activation: str, dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feat_dim
        self.feat_dim = f
        self.u = Dense(f, f, use_bias=False, dtype=dtype)
        self.v = Dense(f, f, use_bias=False, dtype=dtype)
        self.gate = Dense(2 * f, f, activation=activation, dtype=dtype)
        self.split = Dense(f, 3 * f, dtype=dtype)

    def forward(self, s: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        u_v = self.u(v)
        v_v = self.v(v)
        v_v_norm = torch.sqrt(torch.sum(v_v**2 + 1e-10, dim=1))
        split = self.split(self.gate(torch.cat([s, v_v_norm], dim=-1)))
        split = split.reshape(-1, 3, self.feat_dim)
        a_vv, a_sv, a_ss = split[:, 0], split[:, 1], split[:, 2]
        dv = u_v * a_vv[:, None, :]
        ds = torch.sum(u_v * v_v, dim=1) * a_sv + a_ss
        return ds, dv


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 under one power-of-two scale per tensor
    (its largest magnitude maps to at most 448), back in ``t``'s dtype."""
    amax = t.detach().abs().max().float().clamp_min(1e-30)
    scale = torch.exp2(torch.ceil(torch.log2(amax / 448.0)))
    return ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).to(t.dtype)


def _straight_through(fn):
    """``fn`` in the forward pass, the identity in the backward pass (as an
    fp8 training step quantises its operands)."""
    def apply(t: torch.Tensor) -> torch.Tensor:
        return t + (fn(t) - t).detach()
    return apply


PRECISIONS = {"bfloat16": None, "float32": None, "fp8": _straight_through(fp8_round),
              "bf16_messages": None}


def set_precision(model: nn.Module, precision: str) -> nn.Module:
    """Round every Dense product's operands to ``precision`` ("fp8") or
    leave them in the compute dtype (the configuration's own). With
    "bf16_messages" the dense message blocks (those with a
    ``message_dtype``: kernels 1-4's function, float32 in the port) take
    their pair sums in bfloat16, the geometry still in float32."""
    quant = PRECISIONS[precision]
    messages = torch.bfloat16 if precision == "bf16_messages" else torch.float32
    for mod in model.modules():
        if isinstance(mod, Dense):
            mod.quant = quant
        if hasattr(mod, "message_dtype"):
            mod.message_dtype = messages
    return model
