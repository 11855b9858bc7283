"""Convert the JAX package's DenseCGVAE or CGequiVAE parameters into the
port's state_dict.

    state = convert_flax_params(jax.device_get(params), cfg.model)
    model = build_flagship_model(cfg.model)
    model.load_state_dict(state)

``params`` is the flax ``params`` collection as a nested dict of numpy
arrays; nothing here imports JAX. Flax names submodules by class and call
order, so in ``DenseCGVAE``:

  EmbeddingZeroPad_0 / _1            atom / bead embeddings
  DenseFactoredEquiMessage_0..E-1    encoder, E..2E-1 prior,
                                     2E.. the cross/painn decoder
  DenseContractive_0..E-1            encoder contraction
  MLP_0 / MLP_1                      prior mu / logvar heads
  MLP_2 / MLP_3                      posterior mu / logvar heads
  DenseEquiMessagePseudo_0..D-1      pseudo decoder
  DenseUpdateBlock_0..D-1            decoder updates

A flax ``kernel`` (in, out) becomes a torch ``weight`` (out, in);
``filter_w`` (R+1, S, F) is copied as it is. The pseudo block is accepted in
both JAX trees: the ``pseudo_impl="pallas"`` tree (Dense_0, Dense_1,
filter_w) and the default stacked/einsum tree, whose DistanceEmbed kernel
(R, 9F) and bias (9F) become filter_w = [kernel.reshape(R, 9, F);
bias.reshape(1, 9, F)] -- the same function, since the envelope multiplies
both.

The sparse ``CGequiVAE`` (a tree with ``encoder``, ``prior_net`` and
``dec``) maps module for module: ``EquiMessageBlock_i`` ->
``encoder.msgs.i`` (its ``InvariantMessage_0`` -> ``.inv``, whose
``DistanceEmbed_0`` -> ``.embed``), ``ContractiveMessageBlock_i`` ->
``encoder.contract.i``, the decoder's message blocks -> ``dec.msgs.i``
(pseudo2's ``mix_dv``/``mix_dvbar`` as they are), ``UpdateBlock_i`` ->
``dec.updates.i``, the MLP heads and ``euclidean``.

``PCN`` and ``StochasticPCN`` (a tree with ``embedding`` at the top) map
the same way: ``dec`` as above, ``embedding``, and for the stochastic one
``atom_embedding``, ``enc_contract``, ``enc_msgs_i`` -> ``enc_msgs.i``,
``enc_upds_i`` -> ``enc_upds.i``, ``munet``, ``sigmanet``, ``latent_mix``
and ``prior_net``. Every flax leaf must be consumed; a leftover or missing
one raises.

``convert_diffpool_params`` maps a ``DiffPoolVAE`` tree: the pooler's
``EmbeddingZeroPad_0``, ``MLP_i`` convs (``MLP_<nconv>``, the per-atom
logits) and ``assign_map``; per dense stack ``DenseEquiMessageBlock_i`` ->
``msgs.i`` (its ``DenseInvariantMessage_0`` -> ``.inv``),
``DenseUpdateBlock_i`` -> ``updates.i``, the encoder's ``DenseContract_i``
-> ``contract.i`` (``Dense_0`` the distance filter, ``Dense_1`` / ``_2``
phi), the prior's ``Dense_0..3`` -> ``mu_in``, ``mu_out``, ``logvar_in``,
``logvar_out``, the decoder's ``channel_pooler``, and the two MLP heads.
``convert_baseline_params`` maps a baseline of the zoo by name, and
``convert_equistack_params`` the halo stack's ``EquiStack``
(``EquiMessageBlock_i`` -> ``msgs.i``, ``UpdateBlock_i`` -> ``updates.i``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import DiffPoolConfig, ModelConfig


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))


class _Tree:
    """Reads leaves out of a nested flax dict and records which were read."""

    def __init__(self, params: Mapping):
        self.params = params
        self.used = set()

    def has(self, *path: str) -> bool:
        node = self.params
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                return False
            node = node[p]
        return True

    def leaf(self, *path: str) -> np.ndarray:
        node = self.params
        for p in path:
            if not isinstance(node, Mapping) or p not in node:
                raise KeyError(f"flax params have no {'/'.join(path)}")
            node = node[p]
        self.used.add(path)
        return np.asarray(node)

    def all_leaves(self, node=None, prefix=()):
        node = self.params if node is None else node
        for k, v in node.items():
            if isinstance(v, Mapping):
                yield from self.all_leaves(v, prefix + (k,))
            else:
                yield prefix + (k,)


_SPARSE_DEC_BLOCKS = {"pseudo": "EquiMessagePseudo", "pseudo2": "EquiMessagePseudo2",
                      "cross": "EquiMessageCross", "painn": "EquiMessageBlock",
                      "en": "ENMessageBlock", "inv": "InvMessageBlock"}


def convert_flax_params(params: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax DenseCGVAE or CGequiVAE params) ->
    the port's state_dict of the same model."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    tree = _Tree(params)
    out: Dict[str, torch.Tensor] = {}
    if "encoder" in params:
        _sparse(tree, cfg, out)
        _check_consumed(tree)
        return out
    if "embedding" in params:
        _pcn(tree, cfg, out)
        _check_consumed(tree)
        return out

    def dense(dst: str, *src: str, bias: bool = True) -> None:
        _dense(tree, out, dst, *src, bias=bias)

    def factored(dst: str, src: str) -> None:
        dense(f"{dst}.phi_in", src, "Dense_0")
        dense(f"{dst}.phi_out", src, "Dense_1")
        out[f"{dst}.filter_w"] = _tensor(tree.leaf(src, "filter_w"))

    def mlp(dst: str, src: str) -> None:
        for layer in range(2):
            dense(f"{dst}.layers.{layer}", src, f"Dense_{layer}")

    def pseudo(dst: str, src: str) -> None:
        if tree.has(src, "filter_w"):
            factored(dst, src)
            return
        inv = (src, "DenseInvariantMessage_0")
        dense(f"{dst}.phi_in", *inv, "Dense_0")
        dense(f"{dst}.phi_out", *inv, "Dense_1")
        de = inv + ("DistanceEmbed_0", "Dense_0", "Dense_0")
        kernel = tree.leaf(*de, "kernel")                   # (R, 9F)
        bias = tree.leaf(*de, "bias")                       # (9F,)
        f = cfg.n_basis
        out[f"{dst}.filter_w"] = _tensor(np.concatenate(
            [kernel.reshape(cfg.n_rbf, 9, f), bias.reshape(1, 9, f)], axis=0
        ))

    enc = cfg.enc_nconv
    out["atom_embed.weight"] = _tensor(tree.leaf("EmbeddingZeroPad_0", "Embed_0", "embedding"))
    out["bead_embed.weight"] = _tensor(tree.leaf("EmbeddingZeroPad_1", "Embed_0", "embedding"))
    for i in range(enc):
        factored(f"enc_msgs.{i}", f"DenseFactoredEquiMessage_{i}")
        factored(f"prior_msgs.{i}", f"DenseFactoredEquiMessage_{enc + i}")
        con = f"DenseContractive_{i}"
        dense(f"enc_contract.{i}.phi_in", con, "Dense_0")
        dense(f"enc_contract.{i}.phi_out", con, "Dense_1")
        dense(f"enc_contract.{i}.embed.dense", con, "DistanceEmbed_0", "Dense_0")
    for k, head in enumerate(("prior_mu", "prior_logvar", "post_mu", "post_logvar")):
        mlp(head, f"MLP_{k}")
    for i in range(cfg.dec_nconv):
        if cfg.dec_type == "pseudo":
            pseudo(f"dec_msgs.{i}", f"DenseEquiMessagePseudo_{i}")
        else:
            factored(f"dec_msgs.{i}", f"DenseFactoredEquiMessage_{2 * enc + i}")
        upd = (f"DenseUpdateBlock_{i}", "UpdateBlock_0")
        dense(f"dec_updates.{i}.update.u", *upd, "Dense_0", bias=False)
        dense(f"dec_updates.{i}.update.v", *upd, "Dense_1", bias=False)
        dense(f"dec_updates.{i}.update.gate", *upd, "Dense_2")
        dense(f"dec_updates.{i}.update.split", *upd, "Dense_3")

    _check_consumed(tree)
    return out


def _dense(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, *src: str,
           bias: bool = True) -> None:
    """modules.Dense wraps one nn.Dense, named Dense_0."""
    out[f"{dst}.weight"] = _tensor(tree.leaf(*src, "Dense_0", "kernel").T)
    if bias:
        out[f"{dst}.bias"] = _tensor(tree.leaf(*src, "Dense_0", "bias"))


def _inv(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, *src: str) -> None:
    """An edge block's InvariantMessage_0 -> ``<dst>.inv``."""
    src = src + ("InvariantMessage_0",)
    _dense(tree, out, f"{dst}.inv.phi_in", *src, "Dense_0")
    _dense(tree, out, f"{dst}.inv.phi_out", *src, "Dense_1")
    _dense(tree, out, f"{dst}.inv.embed.dense", *src, "DistanceEmbed_0", "Dense_0")


def _mlp(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, *src: str,
         n_layers: int = 2) -> None:
    for layer in range(n_layers):
        _dense(tree, out, f"{dst}.layers.{layer}", *src, f"Dense_{layer}")


def _update(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, *src: str) -> None:
    _dense(tree, out, f"{dst}.u", *src, "Dense_0", bias=False)
    _dense(tree, out, f"{dst}.v", *src, "Dense_1", bias=False)
    _dense(tree, out, f"{dst}.gate", *src, "Dense_2")
    _dense(tree, out, f"{dst}.split", *src, "Dense_3")


def _contract(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, *src: str) -> None:
    _dense(tree, out, f"{dst}.phi_in", *src, "Dense_0")
    _dense(tree, out, f"{dst}.phi_out", *src, "Dense_1")
    _dense(tree, out, f"{dst}.embed.dense", *src, "DistanceEmbed_0", "Dense_0")


def _embedding(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, *src: str) -> None:
    out[f"{dst}.weight"] = _tensor(tree.leaf(*src, "Embed_0", "embedding"))


def _sparse_dec(tree: _Tree, cfg: ModelConfig, out: Dict[str, torch.Tensor]) -> None:
    """The ``dec`` subtree of CGequiVAE and PCN."""
    block = _SPARSE_DEC_BLOCKS[cfg.dec_type]
    for i in range(cfg.dec_nconv):
        _inv(tree, out, f"dec.msgs.{i}", "dec", f"{block}_{i}")
        if cfg.dec_type == "pseudo2":
            for name in ("mix_dv", "mix_dvbar"):
                out[f"dec.msgs.{i}.{name}"] = _tensor(tree.leaf("dec", f"{block}_{i}", name))
        if cfg.dec_type != "en":
            _update(tree, out, f"dec.updates.{i}", "dec", f"UpdateBlock_{i}")


def _sparse(tree: _Tree, cfg: ModelConfig, out: Dict[str, torch.Tensor]) -> None:
    for part in ("encoder", "prior_net"):
        _embedding(tree, out, f"{part}.embed", part, "EmbeddingZeroPad_0")
        for i in range(cfg.enc_nconv):
            _inv(tree, out, f"{part}.msgs.{i}", part, f"EquiMessageBlock_{i}")
    for i in range(cfg.enc_nconv):
        _contract(tree, out, f"encoder.contract.{i}", "encoder", f"ContractiveMessageBlock_{i}")
    _mlp(tree, out, "prior_net.mu", "prior_net", "MLP_0")
    _mlp(tree, out, "prior_net.logvar", "prior_net", "MLP_1")
    _mlp(tree, out, "atom_munet", "atom_munet")
    _mlp(tree, out, "atom_sigmanet", "atom_sigmanet")
    _sparse_dec(tree, cfg, out)
    if not cfg.equivariant:
        _dense(tree, out, "euclidean", "euclidean")


def _pcn(tree: _Tree, cfg: ModelConfig, out: Dict[str, torch.Tensor]) -> None:
    # PCN builds its decoder from dec_type as the JAX package does: pseudo
    # and pseudo2 as they are, painn without the cross term, else cross
    if cfg.dec_type not in ("pseudo", "pseudo2", "painn"):
        cfg = dataclasses.replace(cfg, dec_type="cross")
    _embedding(tree, out, "embedding", "embedding")
    _sparse_dec(tree, cfg, out)
    if not tree.has("atom_embedding"):
        return
    n_enc = max(cfg.enc_nconv, 1)
    _embedding(tree, out, "atom_embedding", "atom_embedding")
    _contract(tree, out, "enc_contract", "enc_contract")
    for i in range(n_enc):
        _inv(tree, out, f"enc_msgs.{i}", f"enc_msgs_{i}")
    for i in range(n_enc + 1):
        _update(tree, out, f"enc_upds.{i}", f"enc_upds_{i}")
    _mlp(tree, out, "munet", "munet")
    _mlp(tree, out, "sigmanet", "sigmanet")
    _dense(tree, out, "latent_mix", "latent_mix")
    _embedding(tree, out, "prior_net.embed", "prior_net", "EmbeddingZeroPad_0")
    for i in range(n_enc):
        _inv(tree, out, f"prior_net.msgs.{i}", "prior_net", f"EquiMessageBlock_{i}")
    _mlp(tree, out, "prior_net.mu", "prior_net", "MLP_0")
    _mlp(tree, out, "prior_net.logvar", "prior_net", "MLP_1")


def _dense_stack(tree: _Tree, out: Dict[str, torch.Tensor], dst: str, src: str,
                 n_conv: int) -> None:
    """The message and update blocks of a DiffPool dense stack."""
    for i in range(n_conv):
        inv = (src, f"DenseEquiMessageBlock_{i}", "DenseInvariantMessage_0")
        _dense(tree, out, f"{dst}.msgs.{i}.inv.phi_in", *inv, "Dense_0")
        _dense(tree, out, f"{dst}.msgs.{i}.inv.phi_out", *inv, "Dense_1")
        _dense(tree, out, f"{dst}.msgs.{i}.inv.embed.dense", *inv, "DistanceEmbed_0", "Dense_0")
        _update(tree, out, f"{dst}.updates.{i}.update", src, f"DenseUpdateBlock_{i}",
                "UpdateBlock_0")


def convert_diffpool_params(params: Mapping, cfg: DiffPoolConfig) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax DiffPoolVAE params) -> the port's
    state_dict. The pooler's mode is read from the tree."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    tree = _Tree(params)
    out: Dict[str, torch.Tensor] = {}
    _embedding(tree, out, "pooler.embed", "pooler", "EmbeddingZeroPad_0")
    for i in range(cfg.pool_nconv):
        _mlp(tree, out, f"pooler.convs.{i}", "pooler", f"MLP_{i}")
    if tree.has("pooler", "assign_map"):
        out["pooler.assign_map"] = _tensor(tree.leaf("pooler", "assign_map"))
    elif tree.has("pooler", f"MLP_{cfg.pool_nconv}"):
        _mlp(tree, out, "pooler.logits", "pooler", f"MLP_{cfg.pool_nconv}")
    for part, n_conv in (("prior_net", cfg.enc_nconv), ("encoder", cfg.enc_nconv),
                         ("decoder", cfg.dec_nconv)):
        _dense_stack(tree, out, part, part, n_conv)
    for i in range(cfg.enc_nconv):
        for name, layer in (("filter", 0), ("phi_in", 1), ("phi_out", 2)):
            _dense(tree, out, f"encoder.contract.{i}.{name}", "encoder", f"DenseContract_{i}",
                   f"Dense_{layer}")
    for layer, name in enumerate(("mu_in", "mu_out", "logvar_in", "logvar_out")):
        _dense(tree, out, f"prior_net.{name}", "prior_net", f"Dense_{layer}")
    out["decoder.channel_pooler"] = _tensor(tree.leaf("decoder", "channel_pooler"))
    _mlp(tree, out, "atom_munet", "atom_munet")
    _mlp(tree, out, "atom_sigmanet", "atom_sigmanet")
    _check_consumed(tree)
    return out


def convert_baseline_params(params: Mapping, name: str) -> Dict[str, torch.Tensor]:
    """Nested dict of numpy arrays (flax params of the baseline ``name``)
    -> the port's state_dict: ``B`` as it is, each ``MLP_i`` with all its
    ``Dense_k``, and EdgeSetMLP's ``SetTransform_i`` (``MLP_0`` ->
    ``update``, ``MLP_1`` -> ``mix``)."""
    if "params" in params and len(params) == 1:
        params = params["params"]
    tree = _Tree(params)
    out: Dict[str, torch.Tensor] = {}

    def mlp(dst: str, *src: str) -> None:
        node = tree.params
        for p in src:
            node = node[p]
        _mlp(tree, out, dst, *src, n_layers=len(node))

    name = name.lower()
    if name in ("linear", "equilinear"):
        out["B"] = _tensor(tree.leaf("B"))
    elif name == "edgesetmlp":
        i = 0
        while tree.has(f"SetTransform_{i}"):
            mlp(f"sets.{i}.update", f"SetTransform_{i}", "MLP_0")
            mlp(f"sets.{i}.mix", f"SetTransform_{i}", "MLP_1")
            i += 1
        mlp("coeffs", "MLP_0")
    else:
        mlp("coeffs", "MLP_0")
    _check_consumed(tree)
    return out


def convert_equistack_params(params: Mapping, n_conv: int) -> Dict[str, torch.Tensor]:
    """The JAX package's ``parallel.halo.EquiStack`` tree
    (``EquiMessageBlock_i``, ``UpdateBlock_i``) -> the state_dict of the
    port's ``parallel.halo.EquiStack``."""
    tree = _Tree(params)
    out: Dict[str, torch.Tensor] = {}
    for i in range(n_conv):
        _inv(tree, out, f"msgs.{i}", f"EquiMessageBlock_{i}")
        _update(tree, out, f"updates.{i}", f"UpdateBlock_{i}")
    _check_consumed(tree)
    return out


def _check_consumed(tree: _Tree) -> None:
    unused = [p for p in tree.all_leaves() if p not in tree.used]
    if unused:
        raise ValueError(
            "flax params not mapped onto the port: "
            + ", ".join("/".join(p) for p in unused[:8])
        )
