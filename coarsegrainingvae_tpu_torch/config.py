"""Configuration dataclasses for models, data and training.

A plain-Python copy of ``coarsegrainingvae_tpu.config``: the same fields,
defaults and JSON layout, so a run's ``modelparams.json`` loads into either
package. Fields that name a JAX formulation (``message_impl``,
``pseudo_impl``, ``compute_dtype``) are kept for that round trip; the port's
dense model always routes its messages through the CUDA kernels.
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    """Hyperparameters of the CGequiVAE model family.

    Mirrors the CLI surface of the reference trainer (run_ala.py:417-482).
    """

    n_cgs: int = 3
    n_basis: int = 600          # feature width F (-n_basis)
    n_rbf: int = 8              # radial basis size (-n_rbf)
    atom_cutoff: float = 8.5    # atom-graph radius cutoff, Angstrom
    cg_cutoff: float = 9.5      # CG-graph radius cutoff, Angstrom
    enc_nconv: int = 4          # encoder conv depth (-enc_nconv)
    dec_nconv: int = 5          # decoder conv depth (-dec_nconv)
    activation: str = "swish"
    # contraction (atom->CG pooling) cutoff; hard-coded 20.0 at the reference
    # call site (cgvae.py:249)
    contract_cutoff: float = 20.0
    dec_type: str = "pseudo"    # "pseudo" | "pseudo2" | "cross" | "painn" | "en" | "inv"
    breaksym: bool = False      # init pseudoscalar channel to 1 (cgvae.py:91-94)
    det: bool = False           # deterministic AE mode (no sampling)
    equivariant: bool = True    # False -> linear "euclidean" head (cgvae.py:424)
    offset: bool = True         # COM re-centering constraint (cgvae.py:478-481)
    # rsqrt(degree) message normalization: needed for numerical stability
    # on large/high-degree graphs (spike-protein scale); the reference has
    # no normalization (its graphs are small), so default False for parity
    degree_norm: bool = False
    # SHAKE-style hard constraint: snap each H onto its covalent bond
    # length along the decoded direction (models/cgvae.py::
    # project_h_bonds). Opt-in extension, no reference analogue; default
    # False = reference loss/metric surface
    h_project: bool = False
    # eval-only variant: the training loss sees the raw decoder (reference
    # dynamics untouched); reconstruct/generate outputs get the projection
    h_project_eval: bool = False
    dropout: float = 0.0
    # force the sparse (segment-sum) formulation even where the dense
    # regime applies; persisted so a finished run reloads with the SAME
    # model class (cli/postanalysis.py restores by this field)
    sparse: bool = False
    # compute dtype for dense-layer matmuls ("float32" or "bfloat16");
    # geometry (coordinates, distances, unit vectors) always stays float32
    # and params are stored float32 either way (the JAX package's default)
    compute_dtype: str = "bfloat16"
    # the JAX package's formulation of the factored message
    # ("einsum" | "qmat" | "pallas") and of the pseudo message
    # ("stacked" | "einsum" | "pallas"). All compute the same function; the
    # port reads neither and always runs its fused CUDA kernels. They stay
    # so a JAX run's config loads unchanged.
    message_impl: str = "einsum"
    pseudo_impl: str = "stacked"


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "dipeptide"
    ndata: int = 20000
    batch_size: int = 32
    cg_method: str = "newman"   # cgae|newman|minimal|alpha|random|backbonepartition|seqpartition
    edgeorder: int = 2          # high-order bonded-edge expansion (-edgeorder)
    mapshuffle: float = 0.0
    nsplits: int = 5            # K-fold CV
    val_frac: float = 0.1
    shuffle: bool = True
    seed: int = 123             # reference seeds everything to 123 (run_ala.py:36-41)
    auxcutoff: float = 0.0      # optional aux-edge cutoff (generate_aux_edges)
    # explicit CG site atom indices for minimal/alpha mappings (one per
    # bead, e.g. C-alpha atom indices); None falls back to evenly-spaced
    # indices with a loud warning (data/mappings.py)
    site_index: Optional[Tuple[int, ...]] = None
    # maximum edges per frame for the padded radius graphs; None -> computed
    # from data (max over frames, rounded up to a bucket).
    max_atom_edges: Optional[int] = None
    max_cg_edges: Optional[int] = None


@dataclass(frozen=True)
class TrainConfig:
    nepochs: int = 600
    lr: float = 8e-5
    beta: float = 0.05          # KL weight
    gamma: float = 25.0         # graph (bonded-distance) loss weight
    eta: float = 0.0            # orientation loss weight (unused by the reference run scripts)
    kappa: float = 0.0
    grad_clip: float = 0.01     # reference clips grad norm to 0.01 (utils.py:156)
    patience: int = 15          # early-stopping patience
    lr_patience: int = 2        # ReduceLROnPlateau patience (run_ala.py:213)
    lr_factor: float = 0.6      # plateau decay factor (-factor 0.6 default)
    min_lr: float = 5e-8        # scheduler floor (run_ala.py:213-215)
    loss_skip_factor: float = 200.0  # skip batch if loss >= gamma*200 (utils.py:145)
    lowess_frac: float = 0.2    # LOWESS smoothing of val loss (run_ala.py:261-274)
    # Adam moment storage ("float32" | "bfloat16"); update math stays
    # float32 (the JAX package's train/trainer.py::scale_by_adam_compact).
    adam_moment_dtype: str = "bfloat16"
    # excluded-volume hinge on nonbonded pair distances (repo extension,
    # train/losses.py::steric_loss). 0.0 = reference loss exactly; > 0
    # penalizes reconstructions that push nonbonded atoms inside the
    # covalent-validity cutoff + steric_margin. The bond-graph validity
    # metric's dominant failure mode at protein scale.
    zeta: float = 0.0
    steric_margin: float = 0.3
    # per-pair DATA margins for the hinge (train/losses.py::
    # build_steric_tables frames=...): each nonbonded pair's threshold is
    # the training ensemble's own closest approach, clipped into
    # [validity cutoff, validity cutoff + steric_margin] -- the hinge
    # never fights geometry the data itself exhibits. False = uniform
    # margin (round-4 behavior).
    steric_data_margin: bool = False
    # linear warmup of zeta over the first N optimizer STEPS (0 = no
    # ramp). At protein scale a full-weight steric term at step 0 sends
    # the first Adam update down an all-pairs-expansion direction that a
    # deep decoder amplifies into a dead run (see train/trainer.py).
    zeta_warmup: int = 0
    # linear LR warmup over the first N optimizer STEPS (0 = no ramp =
    # reference behavior). The step-0 Adam update is sign-like
    # (m/sqrt(v) has unit scale whatever the gradient magnitude) and the
    # deep chignolin cross decoder can amplify an unlucky first
    # direction by 1e6+ even WITHOUT the steric term (reproduced on the
    # bench chignolin scan, CPU + chip); a short ramp removes the
    # failure mode without changing the converged objective.
    lr_warmup: int = 0
    # upweight X-H bonded-distance terms in the graph loss (repo
    # extension; 1.0 = reference behavior). X-H stretches are the
    # stiffest bonds physically and the dominant residual
    # all-atom-validity failure once zeta removes spurious contacts.
    h_bond_weight: float = 1.0
    # ADDITIVE bonded-distance MSE over H-touching graph edges with its
    # own normalization (repo extension; 0.0 = reference loss). Unlike
    # h_bond_weight's in-mean reweighting (which dilutes the heavy-bond
    # gradient and measured NEGATIVE), this leaves the reference graph
    # term untouched -- see train/losses.py::vae_loss.
    eta_h: float = 0.0
    checkpoint_every: int = 0   # 0 -> only final; N -> every N epochs
    log_every: int = 1


@dataclass(frozen=True)
class DiffPoolConfig:
    """Hyperparameters of the DiffPoolVAE family (run_diffpool.py CLI)."""

    n_atoms: int = 0            # padded atom count (the decoder's channel
                                # pooler has one row per atom)
    n_cgs: int = 3
    feat_dim: int = 512         # -num_features
    n_rbf: int = 7
    atom_cutoff: float = 8.0    # encoder atom-graph cutoff (-cutoff)
    cg_cutoff: float = 30.0     # prior/decoder CG filter cutoff (-cg_cutoff)
    pool_nconv: int = 1         # -nconv_pool
    enc_nconv: int = 2
    dec_nconv: int = 3
    activation: str = "swish"
    cross: bool = True
    det: bool = False
    trainable_map: bool = True  # shared trainable assignment (run_diffpool.py:362-366)
    # gumbel temperature schedule (run_diffpool.py:357-358)
    tau_0: float = 2.0
    tau_min: float = 0.3
    tau_rate: float = 0.004
    compute_dtype: str = "float32"


@dataclass(frozen=True)
class ParallelConfig:
    """Mesh layout. Data parallelism is the main lever at this model scale
    (the reference is single-GPU, SURVEY.md section 2.11)."""

    data_axis: str = "data"
    num_devices: Optional[int] = None  # None -> all available
    # devices along the 'model' (tensor) axis of a 2-D ('data','model')
    # mesh: feature-dim sharding of every n_basis-wide matmul
    # (parallel/mesh.py::tensor_shardings). 1 -> pure data parallelism.
    model_devices: int = 1
    # ZeRO-1-style optimizer-state sharding over the data axis: each chip
    # holds 1/n of the Adam moments and all-gathers updates over ICI
    # (parallel/mesh.py::zero_shardings). Off by default (single-chip runs
    # gain nothing); parity with the replicated optimizer is pinned by
    # tests/test_device_data.py on the virtual 8-device mesh.
    zero_optimizer: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig = field(default_factory=ModelConfig)
    data: DataConfig = field(default_factory=DataConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    logdir: str = "./run"

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, s: str) -> "ExperimentConfig":
        raw = json.loads(s)
        return cls(
            model=ModelConfig(**raw.get("model", {})),
            data=DataConfig(**raw.get("data", {})),
            train=TrainConfig(**raw.get("train", {})),
            parallel=ParallelConfig(**raw.get("parallel", {})),
            logdir=raw.get("logdir", "./run"),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "ExperimentConfig":
        with open(path) as f:
            return cls.from_json(f.read())


# Canonical dipeptide benchmark configuration (reference README.md:58).
DIPEPTIDE_BENCH = ExperimentConfig(
    model=ModelConfig(n_cgs=3, n_basis=600, n_rbf=8, atom_cutoff=8.5,
                      cg_cutoff=9.5, enc_nconv=4, dec_nconv=5,
                      activation="swish", dec_type="pseudo", breaksym=True),
    data=DataConfig(dataset="dipeptide", ndata=20000, batch_size=32,
                    cg_method="cgae", edgeorder=2, nsplits=5),
    train=TrainConfig(nepochs=600, lr=8e-5, beta=0.05, gamma=25.0, patience=15),
)
