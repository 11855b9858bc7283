"""SE(3)-equivariant message-passing blocks (port of
``coarsegrainingvae_tpu.models.conv``).

Vector features are stored as ``(nodes, 3, F)``, as in the JAX package. The
sparse blocks work on flat node arrays (a whole batch is one graph) and a
padded, receiver-sorted edge list: edges are directed pairs ``(i, j) =
(receiver, sender)``; messages gather sender features at ``edges[:, 1]``
and are summed into ``edges[:, 0]`` by ``ops.segment.segment_sum``, whose
CSR reduction gives the same bits on every call (no atomics). Gathers are
advanced indexing, whose backward accumulates in sorted order on the card.
Dtypes follow the JAX package's: Dense layers compute in ``dtype``, the
geometry stays float32, and a product of the two promotes to float32.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from coarsegrainingvae_tpu_torch.models.modules import Dense, DistanceEmbed
from coarsegrainingvae_tpu_torch.ops.geometry import preprocess_r
from coarsegrainingvae_tpu_torch.ops.segment import segment_sum


def cross3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the length-3 axis of (E, 3, F) tensors."""
    a1, a2, a3 = a[:, 0], a[:, 1], a[:, 2]
    b1, b2, b3 = b[:, 0], b[:, 1], b[:, 2]
    return torch.stack(
        [a2 * b3 - a3 * b2, a3 * b1 - a1 * b3, a1 * b2 - a2 * b1], dim=1
    )


class InvariantMessage(nn.Module):
    """phi(s) per node, gathered at the senders, times the RBF distance
    filter: the per-edge invariant message (conv.py:31-75 of the original
    code)."""

    def __init__(self, in_feat_dim: int, out_feat_dim: int, activation: str,
                 n_rbf: int, cutoff: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.phi_in = Dense(in_feat_dim, in_feat_dim, activation=activation,
                            dtype=dtype, generator=generator)
        self.phi_out = Dense(in_feat_dim, out_feat_dim, dtype=dtype, generator=generator)
        self.embed = DistanceEmbed(n_rbf, cutoff, out_feat_dim, dtype, generator)

    def forward(self, s: torch.Tensor, dist: torch.Tensor,
                edges: torch.Tensor) -> torch.Tensor:
        phi = self.phi_out(self.phi_in(s))
        return phi[edges[:, 1]] * self.embed(dist)


def _receiver_sum(data: torch.Tensor, edges: torch.Tensor, num_nodes: int,
                  edge_mask) -> torch.Tensor:
    """Masked sum of per-edge rows into their receivers, whose ids the data
    pipeline sorts."""
    return segment_sum(data, edges[:, 0], num_nodes, edge_mask, indices_are_sorted=True)


class _EdgeBlock(nn.Module):
    """The shared front of the edge blocks: an InvariantMessage of
    ``n_split`` F-wide channels over the edge distances."""

    def __init__(self, feat_dim: int, activation: str, n_rbf: int, cutoff: float,
                 n_split: int, degree_norm: bool = False,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feat_dim, self.n_split, self.degree_norm = feat_dim, n_split, degree_norm
        self.inv = InvariantMessage(feat_dim, n_split * feat_dim, activation, n_rbf,
                                    cutoff, dtype, generator)

    def split(self, s, r_ij, edges):
        dist, unit = preprocess_r(r_ij)
        inv = self.inv(s, dist, edges).reshape(-1, self.n_split, self.feat_dim)
        return inv, unit

    def aggregate(self, ds_ij, dv_ij, edges, num_nodes, edge_mask):
        dv = _receiver_sum(dv_ij, edges, num_nodes, edge_mask)
        ds = _receiver_sum(ds_ij, edges, num_nodes, edge_mask)
        if self.degree_norm:
            ones = torch.ones(edges.shape[0], dtype=ds.dtype, device=ds.device)
            deg = _receiver_sum(ones, edges, num_nodes, edge_mask)
            scale = torch.rsqrt(torch.clamp(deg, min=1.0))
            ds = ds * scale[:, None]
            dv = dv * scale[:, None, None]
        return ds, dv


class EquiMessageBlock(_EdgeBlock):
    """Standard PaiNN message (conv.py:487-563): 3-way split ->
    dv = a * v_j + c * unit, ds = b; ``degree_norm`` scales both by
    rsqrt(degree)."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, degree_norm=False,
                 dtype=torch.float32, generator=None):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 3, degree_norm, dtype, generator)

    def forward(self, s, v, r_ij, edges, edge_mask=None):
        inv, unit = self.split(s, r_ij, edges)
        a, b, c = inv[:, 0], inv[:, 1], inv[:, 2]
        dv_ij = c[:, None, :] * unit[:, :, None] + a[:, None, :] * v[edges[:, 1]]
        return self.aggregate(b, dv_ij, edges, s.shape[0], edge_mask)


class EquiMessageCross(_EdgeBlock):
    """PaiNN message plus the v_i x v_j cross term (conv.py:343-402),
    4-way split."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, degree_norm=False,
                 dtype=torch.float32, generator=None):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 4, degree_norm, dtype, generator)

    def forward(self, s, v, r_ij, edges, edge_mask=None):
        inv, unit = self.split(s, r_ij, edges)
        s0, s1, s2, s3 = inv[:, 0], inv[:, 1], inv[:, 2], inv[:, 3]
        v_i, v_j = v[edges[:, 0]], v[edges[:, 1]]
        dv_ij = (s2[:, None, :] * unit[:, :, None] + s0[:, None, :] * v_j
                 + s3[:, None, :] * cross3(v_i, v_j))
        return self.aggregate(s1, dv_ij, edges, s.shape[0], edge_mask)


class ENMessageBlock(_EdgeBlock):
    """EGNN-style block (conv.py:77-129): 2-way split, dv from the unit
    vectors only, ds invariant."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, degree_norm=False,
                 dtype=torch.float32, generator=None):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 2, degree_norm, dtype, generator)

    def forward(self, s, v, r_ij, edges, edge_mask=None):
        inv, unit = self.split(s, r_ij, edges)
        dv_ij = inv[:, 0][:, None, :] * unit[:, :, None]
        return self.aggregate(inv[:, 1], dv_ij, edges, s.shape[0], edge_mask)


class InvMessageBlock(_EdgeBlock):
    """Invariant-only messages (conv.py:132-163), the --invariantdec
    ablation: vector features pass through untouched."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype=torch.float32,
                 generator=None):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 1, False, dtype, generator)

    def forward(self, s, v, r_ij, edges, edge_mask=None):
        dist, _ = preprocess_r(r_ij)
        return _receiver_sum(self.inv(s, dist, edges), edges, s.shape[0], edge_mask), v


class EquiMessagePseudo(_EdgeBlock):
    """Chirality-aware message block (conv.py:165-242): (s, sbar
    pseudoscalar, v, vbar pseudovector), 9-way split with the products
    v x vbar, v x v, vbar x vbar and the v.vbar dot. As in the original
    code, s and sbar are read at the receiver."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype=torch.float32,
                 generator=None):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 9, False, dtype, generator)

    def forward(self, s, sbar, v, vbar, r_ij, edges, edge_mask=None):
        inv, unit = self.split(s, r_ij, edges)
        sp = [inv[:, k] for k in range(9)]
        i_idx, j_idx = edges[:, 0], edges[:, 1]
        s_i, sbar_i = s[i_idx], sbar[i_idx]
        v_i, v_j = v[i_idx], v[j_idx]
        vbar_i, vbar_j = vbar[i_idx], vbar[j_idx]

        ds_ij = sp[0] * s_i
        dsbar_ij = torch.sum(v_i * vbar_j, dim=1)
        dv_ij = (sp[1][:, None, :] * unit[:, :, None]
                 + sp[2][:, None, :] * v_j
                 + sp[3][:, None, :] * cross3(v_i, vbar_j)
                 + sp[4][:, None, :] * sbar_i[:, None, :] * vbar_j)
        dvbar_ij = (sp[5][:, None, :] * vbar_j
                    + sp[6][:, None, :] * sbar_i[:, None, :] * v_j
                    + sp[7][:, None, :] * cross3(v_i, v_j)
                    + sp[8][:, None, :] * cross3(vbar_i, vbar_j))
        return tuple(_receiver_sum(t, edges, s.shape[0], edge_mask)
                     for t in (ds_ij, dsbar_ij, dv_ij, dvbar_ij))


def pseudo2_edge_terms(sp, s_i, sbar_i, v_i, vbar_i, v_j, vbar_j, unit, w_dv, w_dvbar):
    """Per-edge EquiMessagePseudo2 terms (conv.py:264-340 of the original
    code). sp (E, 4, F); 4-way split:
      ds    = sp[1]
      dsbar = sp[3] * (v_i . vbar_j)
      dv    = sp[2] unit + sp[0] v_j + [s_i v_j | sbar_i vbar_j | v_i x vbar_j] @ w_dv
      dvbar = [s_i vbar_j | sbar_i v_j | v_i x v_j | vbar_i x vbar_j] @ w_dvbar
    """
    ds_ij = sp[:, 1]
    dsbar_ij = sp[:, 3] * torch.sum(v_i * vbar_j, dim=1)
    dv_cat = torch.cat([s_i[:, None, :] * v_j, sbar_i[:, None, :] * vbar_j,
                        cross3(v_i, vbar_j)], dim=-1)
    dv_ij = (sp[:, 2][:, None, :] * unit[:, :, None] + sp[:, 0][:, None, :] * v_j
             + _promoted_matmul(dv_cat, w_dv))
    dvbar_cat = torch.cat([s_i[:, None, :] * vbar_j, sbar_i[:, None, :] * v_j,
                           cross3(v_i, v_j), cross3(vbar_i, vbar_j)], dim=-1)
    return ds_ij, dsbar_ij, dv_ij, _promoted_matmul(dvbar_cat, w_dvbar)


def _promoted_matmul(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a @ w in the promoted dtype of the two, as jnp's matmul computes a
    float32 product of float32 features and a bfloat16 matrix."""
    dtype = torch.promote_types(a.dtype, w.dtype)
    return a.to(dtype) @ w.to(dtype)


class EquiMessagePseudo2(_EdgeBlock):
    """Chirality-aware block with a 4-way split and learned mixing
    (EquiMessagePsuedo2, conv.py:246-340): the interaction terms are
    concatenated on the feature axis and mixed by bias-free (3F, F) and
    (4F, F) matrices. Like the JAX package, the mixing matrices take the
    compute dtype; they are stored float32 and cast."""

    def __init__(self, feat_dim, activation, n_rbf, cutoff, dtype=torch.float32,
                 generator=None):
        super().__init__(feat_dim, activation, n_rbf, cutoff, 4, False, dtype, generator)
        f = feat_dim
        self.dtype = dtype
        # lecun_normal: variance 1 / fan_in; in the compute dtype, as the
        # JAX package declares them (conv.py:330-335)
        self.mix_dv = nn.Parameter(
            (torch.randn(3 * f, f, generator=generator) / math.sqrt(3 * f)).to(dtype))
        self.mix_dvbar = nn.Parameter(
            (torch.randn(4 * f, f, generator=generator) / math.sqrt(4 * f)).to(dtype))

    def forward(self, s, sbar, v, vbar, r_ij, edges, edge_mask=None):
        sp, unit = self.split(s, r_ij, edges)
        i_idx, j_idx = edges[:, 0], edges[:, 1]
        terms = pseudo2_edge_terms(
            sp, s[i_idx], sbar[i_idx], v[i_idx], vbar[i_idx], v[j_idx], vbar[j_idx],
            unit, self.mix_dv.to(self.dtype), self.mix_dvbar.to(self.dtype))
        return tuple(_receiver_sum(t, edges, s.shape[0], edge_mask) for t in terms)


class UpdateBlock(nn.Module):
    """PaiNN node update (conv.py:566-616 of the original code): U, V
    channel mixing of v, gated by an MLP of [s, |Vv|]."""

    def __init__(self, feat_dim: int, activation: str,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feat_dim
        self.feat_dim = f
        self.u = Dense(f, f, use_bias=False, dtype=dtype, generator=generator)
        self.v = Dense(f, f, use_bias=False, dtype=dtype, generator=generator)
        self.gate = Dense(2 * f, f, activation=activation, dtype=dtype,
                          generator=generator)
        self.split = Dense(f, 3 * f, dtype=dtype, generator=generator)

    def forward(self, s: torch.Tensor, v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        u_v = self.u(v)                                       # (N, 3, F)
        v_v = self.v(v)
        # 1e-10 is added to each squared component, before the sum
        v_v_norm = torch.sqrt(torch.sum(v_v**2 + 1e-10, dim=1))   # (N, F)
        split = self.split(self.gate(torch.cat([s, v_v_norm], dim=-1)))
        split = split.reshape(-1, 3, self.feat_dim)
        a_vv, a_sv, a_ss = split[:, 0], split[:, 1], split[:, 2]
        dv = u_v * a_vv[:, None, :]
        inner = torch.sum(u_v * v_v, dim=1)
        ds = inner * a_sv + a_ss
        return ds, dv


class PseudoUpdateBlock(UpdateBlock):
    """Pseudoscalar/pseudovector analogue of UpdateBlock (conv.py:619-673);
    the original decoder builds it but never calls it."""

    def forward(self, sbar: torch.Tensor, vbar: torch.Tensor):
        u_v = self.u(vbar)
        v_v = self.v(vbar)
        v_v_norm = torch.sqrt(torch.sum(v_v**2 + 1e-10, dim=1))
        vector = sbar[:, None, :] * vbar          # pseudo x pseudo = proper vector
        vector_norm = torch.sqrt(torch.sum(vector**2 + 1e-10, dim=1))
        split = self.split(self.gate(torch.cat([vector_norm, v_v_norm], dim=-1)))
        split = split.reshape(-1, 3, self.feat_dim)
        a_vv, a_sv, a_ss = split[:, 0], split[:, 1], split[:, 2]
        dvbar = u_v * a_vv[:, None, :]
        inner = torch.sum(u_v * v_v, dim=1)
        return inner * a_sv * sbar + a_ss * sbar, dvbar


class InvariantFilter(nn.Module):
    """One biased F -> 3F Dense over per-edge invariant messages, split into
    three F-wide filters (conv.py:739-755)."""

    def __init__(self, feat_dim: int, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.feat_dim = feat_dim
        self.dense = Dense(feat_dim, 3 * feat_dim, dtype=dtype, generator=generator)

    def forward(self, m_ij: torch.Tensor):
        f = self.dense(m_ij).reshape(m_ij.shape[0], 3, self.feat_dim)
        return f[:, 0], f[:, 1], f[:, 2]


class ContractiveMessageBlock(nn.Module):
    """Atom -> CG pooling along r_iI = x_i - X_map(i) (conv.py:677-733):
    per-atom messages and one segment sum over the mapping."""

    def __init__(self, feat_dim: int, activation: str, n_rbf: int, cutoff: float,
                 dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feat_dim
        self.feat_dim = f
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype, generator=generator)
        self.phi_out = Dense(f, 3 * f, dtype=dtype, generator=generator)
        self.embed = DistanceEmbed(n_rbf, cutoff, 3 * f, dtype, generator)

    def forward(self, s, v, r_iI, mapping, num_cg: int, atom_mask=None):
        dist, unit = preprocess_r(r_iI)
        phi = self.phi_out(self.phi_in(s))
        inv = (phi * self.embed(dist)).reshape(-1, 3, self.feat_dim)
        a, b, c = inv[:, 0], inv[:, 1], inv[:, 2]
        dv_iI = c[:, None, :] * unit[:, :, None] + a[:, None, :] * v
        dV = segment_sum(dv_iI, mapping, num_cg, atom_mask)
        dS = segment_sum(b, mapping, num_cg, atom_mask)
        return dS, dV
