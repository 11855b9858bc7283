"""Map the JAX package's flax parameter trees onto the port's state_dicts,
and back.

    state = convert_flax_params(jax.device_get(params), cfg.model)
    model = build_flagship_model(cfg.model)
    model.load_state_dict(state)
    tree = to_flax_params(model.state_dict(), cfg.model)   # JAX's tree again

A tree is a nested dict whose leaves are numpy arrays or CPU tensors (the
port's ``utils.flax_msgpack`` reads ``bfloat16`` leaves as tensors); nothing
here imports JAX. Each family is one table of leaf rules: the port's name,
the flax path(s) it comes from, and how (``copy``; ``T``, a flax ``kernel``
(in, out) against a torch ``weight`` (out, in); ``filter``, below). Both
directions are read from the same table, and both consume every leaf of
their input and produce every name of the table, else they raise.

Flax names submodules by class and call order, so in ``DenseCGVAE``:

  EmbeddingZeroPad_0 / _1            atom / bead embeddings
  DenseFactoredEquiMessage_0..E-1    encoder, E..2E-1 prior,
                                     2E.. the cross/painn decoder
  DenseContractive_0..E-1            encoder contraction
  MLP_0 / MLP_1                      prior mu / logvar heads
  MLP_2 / MLP_3                      posterior mu / logvar heads
  DenseEquiMessagePseudo_0..D-1      pseudo decoder
  DenseUpdateBlock_0..D-1            decoder updates

``filter_w`` (R+1, S, F) is copied as it is. The pseudo block has two JAX
trees: the ``pseudo_impl="pallas"`` tree (Dense_0, Dense_1, filter_w) and
the default stacked/einsum tree, whose DistanceEmbed kernel (R, 9F) and
bias (9F) are the ``filter`` rule: filter_w = [kernel.reshape(R, 9, F);
bias.reshape(1, 9, F)], the same function since the envelope multiplies
both. Reading takes either tree; writing writes the one
``cfg.pseudo_impl`` names.

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
and ``prior_net``.

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
Each has its inverse: ``to_flax_params``, ``diffpool_to_flax``,
``baseline_to_flax``, ``equistack_to_flax``.

``train_state_to_flax`` / ``train_state_from_flax`` carry a whole
``run_cgvae`` train state (a ``train.checkpoint`` payload) to and from the
state dict of JAX's ``TrainState``: params, the Adam ``count``, ``mu`` and
``nu`` split per leaf through the same table, ``step`` and ``lr``.
``load_params`` reads a PCN or DiffPool run's ``params.msgpack`` (JAX's or
the port's) or a ``params.pt`` that earlier versions of the port wrote.
"""
from __future__ import annotations

import dataclasses
import os
import re
from typing import Callable, Dict, List, Mapping, Sequence, Tuple, Union

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import DiffPoolConfig, ExperimentConfig, ModelConfig
from coarsegrainingvae_tpu_torch.utils import flax_msgpack

Path = Tuple[str, ...]
StateDict = Dict[str, torch.Tensor]

COPY, TRANSPOSE, FILTER = "copy", "T", "filter"


@dataclasses.dataclass(frozen=True)
class Leaf:
    """One rule: the port's ``name`` and the flax ``paths`` it comes from
    (two for ``FILTER``: the DistanceEmbed kernel and bias)."""
    name: str
    paths: Tuple[Path, ...]
    how: str = COPY

    def to_port(self, leaves: Sequence[torch.Tensor]) -> torch.Tensor:
        if self.how == COPY:
            return leaves[0]
        if self.how == TRANSPOSE:
            return leaves[0].T.contiguous()
        kernel, bias = leaves                                   # (R, 9F), (9F,)
        r, f = kernel.shape[0], bias.shape[0] // 9
        return torch.cat([kernel.reshape(r, 9, f), bias.reshape(1, 9, f)])

    def layout(self, shape: Sequence[int]) -> Tuple[int, int, int]:
        """The port tensor of ``shape`` viewed as (A, L, C), L the last
        dimension of its flax leaves: what a column split of those leaves
        splits."""
        shape = tuple(shape)
        if not shape:
            return 1, 1, 1
        if self.how == COPY:
            return int(np.prod(shape[:-1])), shape[-1], 1
        if self.how == TRANSPOSE:                               # (out, in)
            return 1, shape[0], int(np.prod(shape[1:]))
        return shape[0], int(np.prod(shape[1:])), 1             # (R+1, 9, F) -> 9F

    def to_flax(self, t: torch.Tensor) -> List[torch.Tensor]:
        if self.how == COPY:
            return [t]
        if self.how == TRANSPOSE:
            return [t.T.contiguous()]
        return [t[:-1].reshape(t.shape[0] - 1, -1).contiguous(), t[-1].reshape(-1).contiguous()]


class _Table(List[Leaf]):
    """A family's rules, in the order the builders below append them."""

    def copy(self, dst: str, *src: str) -> None:
        self.append(Leaf(dst, (src,)))

    def dense(self, dst: str, *src: str, bias: bool = True) -> None:
        """modules.Dense wraps one nn.Dense, named Dense_0."""
        self.append(Leaf(f"{dst}.weight", (src + ("Dense_0", "kernel"),), TRANSPOSE))
        if bias:
            self.copy(f"{dst}.bias", *src, "Dense_0", "bias")

    def embedding(self, dst: str, *src: str) -> None:
        self.copy(f"{dst}.weight", *src, "Embed_0", "embedding")

    def mlp(self, dst: str, *src: str, n_layers: int = 2) -> None:
        for layer in range(n_layers):
            self.dense(f"{dst}.layers.{layer}", *src, f"Dense_{layer}")

    def inv(self, dst: str, *src: str) -> None:
        """An edge block's InvariantMessage_0 -> ``<dst>.inv``."""
        src = src + ("InvariantMessage_0",)
        self.dense(f"{dst}.inv.phi_in", *src, "Dense_0")
        self.dense(f"{dst}.inv.phi_out", *src, "Dense_1")
        self.dense(f"{dst}.inv.embed.dense", *src, "DistanceEmbed_0", "Dense_0")

    def update(self, dst: str, *src: str) -> None:
        self.dense(f"{dst}.u", *src, "Dense_0", bias=False)
        self.dense(f"{dst}.v", *src, "Dense_1", bias=False)
        self.dense(f"{dst}.gate", *src, "Dense_2")
        self.dense(f"{dst}.split", *src, "Dense_3")

    def contract(self, dst: str, *src: str) -> None:
        self.dense(f"{dst}.phi_in", *src, "Dense_0")
        self.dense(f"{dst}.phi_out", *src, "Dense_1")
        self.dense(f"{dst}.embed.dense", *src, "DistanceEmbed_0", "Dense_0")


# ------------------------------------------------------------ the tables
_SPARSE_DEC_BLOCKS = {"pseudo": "EquiMessagePseudo", "pseudo2": "EquiMessagePseudo2",
                      "cross": "EquiMessageCross", "painn": "EquiMessageBlock",
                      "en": "ENMessageBlock", "inv": "InvMessageBlock"}


def _dense_cgvae_rules(cfg: ModelConfig, pallas_pseudo: bool) -> _Table:
    t = _Table()

    def factored(dst: str, src: str) -> None:
        t.dense(f"{dst}.phi_in", src, "Dense_0")
        t.dense(f"{dst}.phi_out", src, "Dense_1")
        t.copy(f"{dst}.filter_w", src, "filter_w")

    enc = cfg.enc_nconv
    t.embedding("atom_embed", "EmbeddingZeroPad_0")
    t.embedding("bead_embed", "EmbeddingZeroPad_1")
    for i in range(enc):
        factored(f"enc_msgs.{i}", f"DenseFactoredEquiMessage_{i}")
        factored(f"prior_msgs.{i}", f"DenseFactoredEquiMessage_{enc + i}")
        t.contract(f"enc_contract.{i}", f"DenseContractive_{i}")
    for k, head in enumerate(("prior_mu", "prior_logvar", "post_mu", "post_logvar")):
        t.mlp(head, f"MLP_{k}")
    for i in range(cfg.dec_nconv):
        if cfg.dec_type != "pseudo":
            factored(f"dec_msgs.{i}", f"DenseFactoredEquiMessage_{2 * enc + i}")
        elif pallas_pseudo:
            factored(f"dec_msgs.{i}", f"DenseEquiMessagePseudo_{i}")
        else:
            inv = (f"DenseEquiMessagePseudo_{i}", "DenseInvariantMessage_0")
            t.dense(f"dec_msgs.{i}.phi_in", *inv, "Dense_0")
            t.dense(f"dec_msgs.{i}.phi_out", *inv, "Dense_1")
            de = inv + ("DistanceEmbed_0", "Dense_0", "Dense_0")
            t.append(Leaf(f"dec_msgs.{i}.filter_w", (de + ("kernel",), de + ("bias",)), FILTER))
        t.update(f"dec_updates.{i}.update", f"DenseUpdateBlock_{i}", "UpdateBlock_0")
    return t


def _sparse_dec(t: _Table, cfg: ModelConfig) -> None:
    """The ``dec`` subtree of CGequiVAE and PCN."""
    block = _SPARSE_DEC_BLOCKS[cfg.dec_type]
    for i in range(cfg.dec_nconv):
        t.inv(f"dec.msgs.{i}", "dec", f"{block}_{i}")
        if cfg.dec_type == "pseudo2":
            for name in ("mix_dv", "mix_dvbar"):
                t.copy(f"dec.msgs.{i}.{name}", "dec", f"{block}_{i}", name)
        if cfg.dec_type != "en":
            t.update(f"dec.updates.{i}", "dec", f"UpdateBlock_{i}")


def _sparse_rules(cfg: ModelConfig) -> _Table:
    t = _Table()
    for part in ("encoder", "prior_net"):
        t.embedding(f"{part}.embed", part, "EmbeddingZeroPad_0")
        for i in range(cfg.enc_nconv):
            t.inv(f"{part}.msgs.{i}", part, f"EquiMessageBlock_{i}")
    for i in range(cfg.enc_nconv):
        t.contract(f"encoder.contract.{i}", "encoder", f"ContractiveMessageBlock_{i}")
    t.mlp("prior_net.mu", "prior_net", "MLP_0")
    t.mlp("prior_net.logvar", "prior_net", "MLP_1")
    t.mlp("atom_munet", "atom_munet")
    t.mlp("atom_sigmanet", "atom_sigmanet")
    _sparse_dec(t, cfg)
    if not cfg.equivariant:
        t.dense("euclidean", "euclidean")
    return t


def _pcn_rules(cfg: ModelConfig, stochastic: bool) -> _Table:
    # PCN builds its decoder from dec_type as the JAX package does: pseudo
    # and pseudo2 as they are, painn without the cross term, else cross
    if cfg.dec_type not in ("pseudo", "pseudo2", "painn"):
        cfg = dataclasses.replace(cfg, dec_type="cross")
    t = _Table()
    t.embedding("embedding", "embedding")
    _sparse_dec(t, cfg)
    if not stochastic:
        return t
    n_enc = max(cfg.enc_nconv, 1)
    t.embedding("atom_embedding", "atom_embedding")
    t.contract("enc_contract", "enc_contract")
    for i in range(n_enc):
        t.inv(f"enc_msgs.{i}", f"enc_msgs_{i}")
    for i in range(n_enc + 1):
        t.update(f"enc_upds.{i}", f"enc_upds_{i}")
    t.mlp("munet", "munet")
    t.mlp("sigmanet", "sigmanet")
    t.dense("latent_mix", "latent_mix")
    t.embedding("prior_net.embed", "prior_net", "EmbeddingZeroPad_0")
    for i in range(n_enc):
        t.inv(f"prior_net.msgs.{i}", "prior_net", f"EquiMessageBlock_{i}")
    t.mlp("prior_net.mu", "prior_net", "MLP_0")
    t.mlp("prior_net.logvar", "prior_net", "MLP_1")
    return t


def _diffpool_rules(cfg: DiffPoolConfig, pooler: str) -> _Table:
    """``pooler``: "trainable" (assign_map), "logits" (the per-atom MLP) or
    "fixed" (neither)."""
    t = _Table()
    t.embedding("pooler.embed", "pooler", "EmbeddingZeroPad_0")
    for i in range(cfg.pool_nconv):
        t.mlp(f"pooler.convs.{i}", "pooler", f"MLP_{i}")
    if pooler == "trainable":
        t.copy("pooler.assign_map", "pooler", "assign_map")
    elif pooler == "logits":
        t.mlp("pooler.logits", "pooler", f"MLP_{cfg.pool_nconv}")
    for part, n_conv in (("prior_net", cfg.enc_nconv), ("encoder", cfg.enc_nconv),
                         ("decoder", cfg.dec_nconv)):
        for i in range(n_conv):
            inv = (part, f"DenseEquiMessageBlock_{i}", "DenseInvariantMessage_0")
            t.dense(f"{part}.msgs.{i}.inv.phi_in", *inv, "Dense_0")
            t.dense(f"{part}.msgs.{i}.inv.phi_out", *inv, "Dense_1")
            t.dense(f"{part}.msgs.{i}.inv.embed.dense", *inv, "DistanceEmbed_0", "Dense_0")
            t.update(f"{part}.updates.{i}.update", part, f"DenseUpdateBlock_{i}",
                     "UpdateBlock_0")
    for i in range(cfg.enc_nconv):
        for name, layer in (("filter", 0), ("phi_in", 1), ("phi_out", 2)):
            t.dense(f"encoder.contract.{i}.{name}", "encoder", f"DenseContract_{i}",
                    f"Dense_{layer}")
    for layer, name in enumerate(("mu_in", "mu_out", "logvar_in", "logvar_out")):
        t.dense(f"prior_net.{name}", "prior_net", f"Dense_{layer}")
    t.copy("decoder.channel_pooler", "decoder", "channel_pooler")
    t.mlp("atom_munet", "atom_munet")
    t.mlp("atom_sigmanet", "atom_sigmanet")
    return t


def _baseline_rules(name: str, layers: Callable[[str], int], n_sets: int) -> _Table:
    """``layers(mlp)``: the Dense count of the port's MLP ``mlp``;
    ``n_sets``: EdgeSetMLP's SetTransform count."""
    t = _Table()
    name = name.lower()
    if name in ("linear", "equilinear"):
        t.copy("B", "B")
        return t
    for i in range(n_sets if name == "edgesetmlp" else 0):
        t.mlp(f"sets.{i}.update", f"SetTransform_{i}", "MLP_0",
              n_layers=layers(f"sets.{i}.update"))
        t.mlp(f"sets.{i}.mix", f"SetTransform_{i}", "MLP_1", n_layers=layers(f"sets.{i}.mix"))
    t.mlp("coeffs", "MLP_0", n_layers=layers("coeffs"))
    return t


def _equistack_rules(n_conv: int) -> _Table:
    t = _Table()
    for i in range(n_conv):
        t.inv(f"msgs.{i}", f"EquiMessageBlock_{i}")
        t.update(f"updates.{i}", f"UpdateBlock_{i}")
    return t


# ------------------------------------------------------------ directions
def _as_tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.detach()
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bf16, as JAX hands it out
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _as_leaf(t: torch.Tensor):
    """numpy where numpy has the dtype, else (bf16) the CPU tensor."""
    t = t.detach().cpu().contiguous()
    return t if t.dtype == torch.bfloat16 else t.numpy()


def _unwrap(params: Mapping) -> Mapping:
    if "params" in params and len(params) == 1:
        return params["params"]
    return params


def _get(tree: Mapping, path: Path):
    node = tree
    for p in path:
        if not isinstance(node, Mapping) or p not in node:
            raise KeyError(f"flax params have no {'/'.join(path)}")
        node = node[p]
    return node


def _has(tree: Mapping, *path: str) -> bool:
    try:
        _get(tree, path)
        return True
    except KeyError:
        return False


def _flax_leaves(node: Mapping, prefix: Path = ()):
    for k, v in node.items():
        if isinstance(v, Mapping):
            yield from _flax_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,)


def _rules_to_port(rules: Sequence[Leaf], tree: Mapping) -> StateDict:
    """Every rule applied to ``tree``, each leaf in its own dtype; every
    flax leaf must be read."""
    out: StateDict = {}
    used = set()
    for rule in rules:
        out[rule.name] = rule.to_port([_as_tensor(_get(tree, p)) for p in rule.paths])
        used.update(rule.paths)
    unused = [p for p in _flax_leaves(tree) if p not in used]
    if unused:
        raise ValueError("flax params not mapped onto the port: "
                         + ", ".join("/".join(p) for p in unused[:8]))
    return out


def _rules_to_flax(rules: Sequence[Leaf], sd: Mapping[str, torch.Tensor]) -> Dict:
    """The flax tree of ``sd``; every name of ``sd`` must be read."""
    names = {r.name for r in rules}
    extra, missing = sorted(set(sd) - names), sorted(names - set(sd))
    if extra or missing:
        raise ValueError(f"state_dict does not match the flax table: unexpected {extra[:8]}, "
                         f"missing {missing[:8]}")
    tree: Dict = {}
    for rule in rules:
        for path, leaf in zip(rule.paths, rule.to_flax(_as_tensor(sd[rule.name]))):
            node = tree
            for p in path[:-1]:
                node = node.setdefault(p, {})
            node[path[-1]] = _as_leaf(leaf)
    return tree


# ----------------------------------------------------- families, public API
def _flagship_rules_from_flax(params: Mapping, cfg: ModelConfig) -> _Table:
    if "encoder" in params:
        return _sparse_rules(cfg)
    if "embedding" in params:
        return _pcn_rules(cfg, stochastic="atom_embedding" in params)
    pallas = cfg.dec_type == "pseudo" and _has(params, "DenseEquiMessagePseudo_0", "filter_w")
    return _dense_cgvae_rules(cfg, pallas_pseudo=pallas)


def _flagship_rules_from_port(sd: Mapping, cfg: ModelConfig) -> _Table:
    if "encoder.embed.weight" in sd:
        return _sparse_rules(cfg)
    if "embedding.weight" in sd:
        return _pcn_rules(cfg, stochastic="atom_embedding.weight" in sd)
    return _dense_cgvae_rules(cfg, pallas_pseudo=cfg.pseudo_impl == "pallas")


def tensor_layouts(shapes: Mapping[str, Sequence[int]], cfg: ModelConfig
                   ) -> Dict[str, Tuple[int, int, int]]:
    """Each tensor of a flagship model's state_dict (``shapes``: name ->
    shape) as (A, L, C), L the last dimension of the flax leaves it maps
    to (``Leaf.layout``): what the JAX package's ``tensor_shardings``
    decides a leaf's sharding by (``parallel.tensor``)."""
    rules = {r.name: r for r in _flagship_rules_from_port(shapes, cfg)}
    return {name: rules[name].layout(shape) for name, shape in shapes.items()}


def convert_flax_params(params: Mapping, cfg: ModelConfig) -> StateDict:
    """Nested dict of arrays (flax DenseCGVAE, CGequiVAE, PCN or
    StochasticPCN params) -> the port's state_dict of the same model, each
    tensor in its leaf's dtype (the JAX package keeps ``filter_w``,
    ``mix_dv`` and ``mix_dvbar`` in the compute dtype, as the port's
    models do)."""
    params = _unwrap(params)
    return _rules_to_port(_flagship_rules_from_flax(params, cfg), params)


def to_flax_params(sd: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict:
    """The inverse of ``convert_flax_params``: the port's state_dict ->
    JAX's params tree (the pseudo tree ``cfg.pseudo_impl`` names)."""
    return _rules_to_flax(_flagship_rules_from_port(sd, cfg), sd)


def _pooler_mode(has: Callable[[str], bool]) -> str:
    return "trainable" if has("assign_map") else "logits" if has("logits") else "fixed"


def convert_diffpool_params(params: Mapping, cfg: DiffPoolConfig) -> StateDict:
    """Nested dict of arrays (flax DiffPoolVAE params) -> the port's
    state_dict. The pooler's mode is read from the tree."""
    params = _unwrap(params)
    mode = _pooler_mode(lambda k: _has(params, "pooler", "assign_map") if k == "assign_map"
                        else _has(params, "pooler", f"MLP_{cfg.pool_nconv}"))
    return _rules_to_port(_diffpool_rules(cfg, mode), params)


def diffpool_to_flax(sd: Mapping[str, torch.Tensor], cfg: DiffPoolConfig) -> Dict:
    mode = _pooler_mode(lambda k: f"pooler.{k}" in sd or f"pooler.{k}.layers.0.weight" in sd)
    return _rules_to_flax(_diffpool_rules(cfg, mode), sd)


def convert_baseline_params(params: Mapping, name: str) -> StateDict:
    """Nested dict of arrays (flax params of the baseline ``name``) -> the
    port's state_dict: ``B`` as it is, each ``MLP_i`` with all its
    ``Dense_k``, and EdgeSetMLP's ``SetTransform_i`` (``MLP_0`` ->
    ``update``, ``MLP_1`` -> ``mix``)."""
    params = _unwrap(params)

    def layers(mlp: str) -> int:
        m = re.fullmatch(r"sets\.(\d+)\.(update|mix)", mlp)
        path = (("MLP_0",) if m is None else
                (f"SetTransform_{m[1]}", "MLP_0" if m[2] == "update" else "MLP_1"))
        return len(_get(params, path))

    n_sets = sum(1 for k in params if k.startswith("SetTransform_"))
    return _rules_to_port(_baseline_rules(name, layers, n_sets), params)


def baseline_to_flax(sd: Mapping[str, torch.Tensor], name: str) -> Dict:
    def layers(mlp: str) -> int:
        return sum(1 for k in sd if re.fullmatch(re.escape(mlp) + r"\.layers\.\d+\.weight", k))

    n_sets = len({k.split(".")[1] for k in sd if k.startswith("sets.")})
    return _rules_to_flax(_baseline_rules(name, layers, n_sets), sd)


def convert_equistack_params(params: Mapping, n_conv: int) -> StateDict:
    """The JAX package's ``parallel.halo.EquiStack`` tree
    (``EquiMessageBlock_i``, ``UpdateBlock_i``) -> the state_dict of the
    port's ``parallel.halo.EquiStack``."""
    return _rules_to_port(_equistack_rules(n_conv), params)


def equistack_to_flax(sd: Mapping[str, torch.Tensor], n_conv: int) -> Dict:
    return _rules_to_flax(_equistack_rules(n_conv), sd)


# ------------------------------------------------------------ train state
def _param_order(cfg: ExperimentConfig, sparse: bool) -> List[Tuple[str, torch.Size]]:
    """(name, shape) of the model's parameters in ``named_parameters``
    order, the order of the port's flat Adam moments."""
    from coarsegrainingvae_tpu_torch.models.cgvae import build_flagship_model

    with torch.device("meta"):
        model = build_flagship_model(cfg.model, force_sparse=sparse)
    return [(n, p.shape) for n, p in model.named_parameters()]


def train_state_to_flax(payload: Mapping, cfg: ExperimentConfig) -> Dict:
    """A ``train.checkpoint`` payload -> the state dict of JAX's
    ``TrainState`` (``flax.serialization.to_state_dict`` of it):
    ``{"params", "opt_state": {"0": {}, "1": {"count", "mu", "nu"}},
    "step", "lr"}``. The flat moments are cut at the payload's parameter
    shapes (its order is the model's) and moved leaf by leaf as the params
    are; ``step`` becomes JAX's int32."""
    params = payload["params"]
    rules = _flagship_rules_from_port(params, cfg.model)
    opt = payload["opt_state"]

    def split(flat: torch.Tensor) -> StateDict:
        out, at = {}, 0
        for name, p in params.items():
            out[name] = flat[at:at + p.numel()].reshape(p.shape)
            at += p.numel()
        if at != flat.numel():
            raise ValueError(f"moments hold {flat.numel()} entries, the params {at}")
        return out

    return {
        "params": _rules_to_flax(rules, params),
        "opt_state": {"0": {}, "1": {
            "count": _as_leaf(opt["count"].to(torch.int32)),
            "mu": _rules_to_flax(rules, split(opt["mu"])),
            "nu": _rules_to_flax(rules, split(opt["nu"])),
        }},
        "step": _as_leaf(payload["step"].to(torch.int32)),
        "lr": _as_leaf(payload["lr"].to(torch.float32)),
    }


def train_state_from_flax(tree: Mapping, cfg: ExperimentConfig) -> Dict:
    """The inverse of ``train_state_to_flax``: JAX's ``TrainState`` state
    dict -> a ``train.checkpoint`` payload for the model ``cfg`` builds
    (dense, or sparse when the tree is), moments flat in its parameter
    order and in their stored dtype, ``step`` int64. Dtypes are kept."""
    params_tree = tree["params"]
    rules = _flagship_rules_from_flax(params_tree, cfg.model)
    adam = tree["opt_state"]["1"]
    params = _rules_to_port(rules, params_tree)
    order = _param_order(cfg, sparse="encoder" in params_tree)
    if {n for n, _ in order} != set(params):
        raise ValueError("the flax params do not match the model the config builds")

    def flat(moments: Mapping) -> torch.Tensor:
        sd = _rules_to_port(rules, moments)
        return torch.cat([sd[n].reshape(-1) for n, _ in order])

    return {
        "params": {n: params[n] for n, _ in order},
        "opt_state": {"count": _as_tensor(adam["count"]).to(torch.int32).reshape(()),
                      "mu": flat(adam["mu"]), "nu": flat(adam["nu"])},
        "step": _as_tensor(tree["step"]).to(torch.int64).reshape(()),
        "lr": _as_tensor(tree["lr"]).to(torch.float32).reshape(()),
    }


# ------------------------------------------------------------ run files
def save_params(path: str, sd: Mapping[str, torch.Tensor],
                cfg: Union[ModelConfig, DiffPoolConfig]) -> None:
    """Write ``sd`` as JAX's ``params.msgpack`` (``flax.serialization.
    to_bytes`` of the params tree) for a PCN (``ModelConfig``) or DiffPool
    (``DiffPoolConfig``) model."""
    tree = (diffpool_to_flax(sd, cfg) if isinstance(cfg, DiffPoolConfig)
            else to_flax_params(sd, cfg))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(flax_msgpack.dumps(tree))
    os.replace(tmp, path)


def load_params(path: str, cfg: Union[ModelConfig, DiffPoolConfig, ExperimentConfig]
                ) -> StateDict:
    """The port's state_dict from a run's ``params.msgpack`` (written by the
    JAX package or the port) or a legacy ``params.pt`` (plain tensors by
    name). ``cfg`` says the family: ``DiffPoolConfig`` for DiffPool, else
    the model config of PCN / StochasticPCN."""
    if isinstance(cfg, ExperimentConfig):
        cfg = cfg.model
    if path.endswith(".pt"):
        return dict(torch.load(path, map_location="cpu", weights_only=True))
    with open(path, "rb") as f:
        tree = flax_msgpack.loads(f.read())
    if isinstance(cfg, DiffPoolConfig):
        return convert_diffpool_params(tree, cfg)
    return convert_flax_params(tree, cfg)
