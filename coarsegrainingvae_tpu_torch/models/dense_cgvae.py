"""Dense-mode CGequiVAE (port of ``coarsegrainingvae_tpu.models.dense_cgvae``).

The same model as the JAX package's ``DenseCGVAE``: encode -> conditional CG
prior -> reparametrize -> equivariant pseudo decode -> per-bead channel lift
with the centre-of-mass constraint, on padded ``(B, N, ...)`` batches. Every
message block goes through a fused CUDA kernel on the card
(``ops.fused_message`` for the encoder and prior, ``ops.fused_pseudo`` for
the pseudo decoder); on CPU tensors the kernels' plain versions run.

Entry points: ``forward(batch, eps=None, generator=None)`` returns all six
``VAEOutput`` fields and is differentiable (training runs it under
autograd: each kernel has a hand-written backward kernel); inside a train
epoch program it records the mark ``decode`` before the decoder
(``utils.tracing``);
``generate(batch, generator=None, eps=None)`` returns only the
reconstruction drawn from the prior and skips the encoder, whose outputs
never reach it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from coarsegrainingvae_tpu_torch.config import ModelConfig
from coarsegrainingvae_tpu_torch.data.batch import CGBatch
from coarsegrainingvae_tpu_torch.models.cgvae import (
    VAEOutput,
    draw_eps,
    project_batch_h_bonds,
)
from coarsegrainingvae_tpu_torch.models.dense import (
    DenseFactoredEquiMessage,
    DenseUpdateBlock,
    factored_filter,
)
from coarsegrainingvae_tpu_torch.models.modules import MLP, Dense, DistanceEmbed, EmbeddingZeroPad
from coarsegrainingvae_tpu_torch.ops.fused_pseudo import fused_pseudo_message
from coarsegrainingvae_tpu_torch.utils import tracing

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class DenseEquiMessagePseudo(nn.Module):
    """Dense chirality-aware message block (9-way split), always through the
    fused pseudo kernel. Its parameters are the JAX package's
    ``pseudo_impl="pallas"`` tree; ``convert.convert_flax_params`` also maps
    the default (stacked/einsum) tree onto it.

      ds    = s_i * S(g0)
      dsbar = v_i . sum_j adj vbar_j
      dv    = S(g1 unit) + S(g2 v_j) + v_i x S(g3 vbar_j) + sbar_i * S(g4 vbar_j)
      dvbar = S(g5 vbar_j) + sbar_i * S(g6 v_j) + v_i x S(g7 v_j)
              + vbar_i x S(g8 vbar_j)
    with S(.) the filter-weighted sum over senders j.

    Every output at feature f reads feature f of phi, s, sbar, v, vbar and
    the filter alone, so under a ``feature_split`` (tensor parallelism)
    the kernel runs on this model rank's features (``local``) and the
    outputs are gathered along F.
    """

    def __init__(self, feat_dim: int, activation: str, n_rbf: int,
                 cutoff: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None,
                 filter_dtype: torch.dtype = torch.float32):
        super().__init__()
        f = feat_dim
        self.feat_dim, self.n_rbf, self.cutoff = f, n_rbf, cutoff
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype,
                            generator=generator)
        self.phi_out = Dense(f, 9 * f, dtype=dtype, generator=generator)
        self.filter_w = factored_filter(n_rbf, 9, f, generator, filter_dtype)
        self.feature_split = None

    def forward(self, s, sbar, v, vbar, xyz, node_mask):
        split = self.feature_split
        if split is not None:
            return tuple(split.gather(t) for t in self.local(s, sbar, v, vbar, xyz, node_mask,
                                                             split))
        b, m, f = s.shape
        phi = self.phi_out(self.phi_in(s)).reshape(b, m, 9, f)

        def f32(t):
            return t.float().contiguous()

        return fused_pseudo_message(
            f32(xyz), f32(node_mask), f32(phi), f32(s), f32(sbar), f32(v),
            f32(vbar), f32(self.filter_w), self.cutoff, self.n_rbf,
        )

    def local(self, s, sbar, v, vbar, xyz, node_mask, split):
        """(ds, dsbar, dv, dvbar) at the features of ``split`` alone."""
        phi = split.columns(self.phi_out, split.copy(self.phi_in(s)), 9)

        def f32(t):
            return t.float().contiguous()

        return fused_pseudo_message(
            f32(xyz), f32(node_mask), f32(phi), *(split.slice(t.float()) for t in (s, sbar, v, vbar)),
            split.filter(self.filter_w.float()), self.cutoff, self.n_rbf,
        )


class DenseContractive(nn.Module):
    """Atom -> assigned-bead pooling message (conv.py:677-733 of the original
    code): per-atom filter on r_iI = x_i - X_map(i), aggregated with the
    one-hot assignment as a (B, N, K) contraction."""

    def __init__(self, feat_dim: int, activation: str, n_rbf: int,
                 cutoff: float, dtype: torch.dtype = torch.float32,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        f = feat_dim
        self.feat_dim = f
        self.phi_in = Dense(f, f, activation=activation, dtype=dtype,
                            generator=generator)
        self.phi_out = Dense(f, 3 * f, dtype=dtype, generator=generator)
        self.embed = DistanceEmbed(n_rbf, cutoff, 3 * f, dtype, generator)

    def forward(self, s, v, r_iI, onehot) -> Tuple[torch.Tensor, torch.Tensor]:
        f = self.feat_dim
        d = torch.sqrt(torch.sum(r_iI**2 + 1e-8, dim=-1))
        unit = r_iI / d[..., None]
        phi = self.phi_out(self.phi_in(s))
        inv = (phi * self.embed(d)).reshape(s.shape[:2] + (3, f))
        a, b, c = inv[..., 0, :], inv[..., 1, :], inv[..., 2, :]
        dv = c[:, :, None, :] * unit[..., None] + a[:, :, None, :] * v
        dV = torch.einsum("bnk,bndf->bkdf", onehot, dv)
        dS = torch.einsum("bnk,bnf->bkf", onehot, b)
        return dS, dV


class DenseCGVAE(nn.Module):
    """Dense-regime CGequiVAE with the JAX package's architecture.

    Parameters are drawn on the CPU from ``generator`` (torch's default
    generator when None); move the model with ``.to(device)``. Submodule
    order and names are what ``convert.convert_flax_params`` maps the flax
    tree onto.
    """

    def __init__(self, cfg: ModelConfig, generator: Optional[torch.Generator] = None):
        super().__init__()
        if cfg.dec_type not in ("pseudo", "cross", "painn"):
            # pseudo2/en/inv exist only in the sparse formulation
            raise ValueError(
                f"DenseCGVAE has no dec_type={cfg.dec_type!r} decoder; "
                "pseudo2/en/inv belong to the sparse CGequiVAE"
            )
        self.cfg = c = cfg
        f, g = c.n_basis, generator
        dtype = _DTYPES[c.compute_dtype]
        # the JAX pseudo block keeps filter_w in the compute dtype in its
        # pallas tree and as float32 Dense params in its default tree
        pseudo_filter_dtype = dtype if c.pseudo_impl == "pallas" else torch.float32

        def msg(cutoff, cross=False):
            return DenseFactoredEquiMessage(f, c.activation, c.n_rbf, cutoff,
                                            cross, dtype, g)

        # the reference wires cg_cutoff into the atom-graph encoder's edge
        # filters (run_ala.py:199-201); preserved
        self.atom_embed = EmbeddingZeroPad(100, f, g)
        self.enc_msgs = nn.ModuleList(msg(c.cg_cutoff) for _ in range(c.enc_nconv))
        self.enc_contract = nn.ModuleList(
            DenseContractive(f, c.activation, c.n_rbf, c.contract_cutoff, dtype, g)
            for _ in range(c.enc_nconv)
        )
        # bead-index vocabulary scales with n_cgs (the JAX model sizes it
        # from the batch's bead count, which serving sets to n_cgs)
        self.bead_embed = EmbeddingZeroPad(max(100, c.n_cgs), f, g)
        self.prior_msgs = nn.ModuleList(msg(c.cg_cutoff) for _ in range(c.enc_nconv))
        self.prior_mu = MLP(f, [f, f], activation="Tanh", dtype=dtype, generator=g)
        self.prior_logvar = MLP(f, [f, f], activation="Tanh", dtype=dtype, generator=g)
        self.post_mu = MLP(f, [f, f], activation="ReLU", dtype=dtype, generator=g)
        self.post_logvar = MLP(f, [f, f], activation="ReLU", dtype=dtype, generator=g)
        if c.dec_type == "pseudo":
            self.dec_msgs = nn.ModuleList(
                DenseEquiMessagePseudo(f, c.activation, c.n_rbf, c.atom_cutoff,
                                       dtype, g, filter_dtype=pseudo_filter_dtype)
                for _ in range(c.dec_nconv)
            )
        else:
            self.dec_msgs = nn.ModuleList(
                msg(c.atom_cutoff, cross=c.dec_type == "cross")
                for _ in range(c.dec_nconv)
            )
        self.dec_updates = nn.ModuleList(
            DenseUpdateBlock(f, c.activation, dtype, g) for _ in range(c.dec_nconv)
        )

    # ------------------------------------------------------------ pieces
    def _assignment(self, batch: CGBatch) -> Tuple[torch.Tensor, torch.Tensor]:
        m = batch.cg_z.shape[1]
        onehot = F.one_hot(batch.mapping, m).to(torch.float32)
        onehot = onehot * batch.atom_mask[..., None].to(torch.float32)
        norm = onehot / torch.clamp(onehot.sum(dim=1, keepdim=True), min=1e-8)
        return onehot, norm

    def _encode(self, batch: CGBatch, onehot, norm):
        c, f = self.cfg, self.cfg.n_basis
        b, n = batch.z.shape
        m = batch.cg_z.shape[1]
        xyz = batch.xyz
        r_iI = xyz - torch.einsum("bkd,bnk->bnd", batch.cg_xyz, onehot)
        h = self.atom_embed(batch.z)
        v = torch.zeros((b, n, 3, f), dtype=h.dtype, device=h.device)
        H = torch.zeros((b, m, f), dtype=h.dtype, device=h.device)
        V = torch.zeros((b, m, 3, f), dtype=h.dtype, device=h.device)
        for i in range(c.enc_nconv):
            ds, dv = self.enc_msgs[i](h, v, xyz, batch.atom_mask)
            h = h + ds
            v = v + dv
            if i == 0:
                H = torch.einsum("bnk,bnf->bkf", norm, h)
                V = torch.einsum("bnk,bndf->bkdf", norm, v)
            dH, dV = self.enc_contract[i](h, v, r_iI, onehot)
            H = H + dH
            V = V + dV
        mu = self.post_mu(H)
        sigma = 1e-12 + torch.exp(torch.clamp(self.post_logvar(H), -30.0, 30.0) / 2.0)
        return H, mu, sigma

    def _prior(self, batch: CGBatch):
        f = self.cfg.n_basis
        b, m = batch.cg_z.shape
        Hp = self.bead_embed(batch.cg_z)
        Vp = torch.zeros((b, m, 3, f), dtype=Hp.dtype, device=Hp.device)
        for layer in self.prior_msgs:
            dH, dV = layer(Hp, Vp, batch.cg_xyz, batch.cg_mask)
            Hp = Hp + dH
            Vp = Vp + dV
        prior_mu = self.prior_mu(Hp)
        # logvar clamps: an unbounded variance head can walk exp() to inf
        prior_sigma = 1e-9 + torch.exp(
            torch.clamp(self.prior_logvar(Hp), -30.0, 30.0) / 2.0
        )
        return prior_mu, prior_sigma

    def _decode(self, batch: CGBatch, z_lat, onehot, norm) -> torch.Tensor:
        """(B*N, 3) decoded coordinates, H-projected when ``h_project``."""
        c = self.cfg
        b, m, f = z_lat.shape
        S = z_lat
        Vd = torch.zeros((b, m, 3, f), dtype=S.dtype, device=S.device)
        if c.dec_type == "pseudo":
            Sbar = torch.ones_like(S) if c.breaksym else torch.zeros_like(S)
            Vbar = torch.zeros_like(Vd)
            for msg, upd in zip(self.dec_msgs, self.dec_updates):
                dS, dSb, dV, dVb = msg(S, Sbar, Vd, Vbar, batch.cg_xyz, batch.cg_mask)
                S, Sbar, Vd, Vbar = S + dS, Sbar + dSb, Vd + dV, Vbar + dVb
                dS, dV = upd(S, Vd)
                S, Vd = S + dS, Vd + dV
        else:
            for msg, upd in zip(self.dec_msgs, self.dec_updates):
                dS, dV = msg(S, Vd, batch.cg_xyz, batch.cg_mask)
                S, Vd = S + dS, Vd + dV
                dS, dV = upd(S, Vd)
                S, Vd = S + dS, Vd + dV

        # channel lift: atom n reads channel channel_idx[n] of its bead's V
        bi = torch.arange(b, device=Vd.device)[:, None]
        xyz_rel = Vd[bi, batch.mapping, :, batch.channel_idx]       # (B, N, 3)
        if c.offset:
            offsets = torch.einsum("bnk,bnd->bkd", norm, xyz_rel)
            xyz_rel = xyz_rel - torch.einsum("bkd,bnk->bnd", offsets, onehot)
        anchor = torch.einsum("bkd,bnk->bnd", batch.cg_xyz, onehot)
        xyz_recon = (xyz_rel + anchor).reshape(-1, 3)
        if c.h_project:
            xyz_recon = project_batch_h_bonds(xyz_recon, batch)
        return xyz_recon

    # ------------------------------------------------------- entry points
    def forward(self, batch: CGBatch, eps: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> VAEOutput:
        """Reconstruction through the posterior (the sample is H itself
        when ``cfg.det``; otherwise mu + sigma * eps, eps drawn from
        ``generator`` unless given)."""
        b, n = batch.z.shape
        m = batch.cg_z.shape[1]
        f = self.cfg.n_basis
        onehot, norm = self._assignment(batch)
        H, mu, sigma = self._encode(batch, onehot, norm)
        prior_mu, prior_sigma = self._prior(batch)
        z_lat = H if self.cfg.det else mu + sigma * draw_eps(mu, generator, eps)
        tracing.mark("decode")
        xyz_recon = self._decode(batch, z_lat, onehot, norm)
        return VAEOutput(
            mu=mu.reshape(b * m, f), sigma=sigma.reshape(b * m, f),
            prior_mu=prior_mu.reshape(b * m, f),
            prior_sigma=prior_sigma.reshape(b * m, f),
            xyz=batch.xyz.reshape(b * n, 3), xyz_recon=xyz_recon,
        )

    def generate(self, batch: CGBatch, generator: Optional[torch.Generator] = None,
                 eps: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(B*N, 3) all-atom coordinates drawn from the prior given the CG
        geometry: prior_mu + prior_sigma * eps, then decode. Atom
        coordinates in ``batch`` are read only by ``h_project``, for bond
        lengths."""
        onehot, norm = self._assignment(batch)
        prior_mu, prior_sigma = self._prior(batch)
        z_lat = prior_mu + prior_sigma * draw_eps(prior_mu, generator, eps)
        return self._decode(batch, z_lat, onehot, norm)
