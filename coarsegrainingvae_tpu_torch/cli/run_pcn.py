"""PCN protein-backmapping CLI (port of
``coarsegrainingvae_tpu.cli.run_pcn``; scripts/run_pdb.py of the original
code).

Workflow (run_pdb.py:232-489): load proteins (SidechainNet pickles or
synthetic stand-ins) -> padded PCN dataset -> ``PCNTrainer.fit`` with the
dihedral-augmented loss (pcn_utils.py:185-193) -> per-protein test metrics
(RMSD, dRMSD, GED, inference time) to ``test_results.csv`` and PDB dumps
(save_selected_recon, run_pdb.py:33-75). The JAX CLI's flags and defaults,
plus ``--device`` (default ``cuda``). The best validation parameters go to
``params.msgpack`` in JAX's tree, as the JAX package writes it
(``convert.save_params``; ``convert.load_params`` reads it back).

    python -m coarsegrainingvae_tpu_torch.cli.run_pcn -logdir /tmp/pcn \
        -ndata 16 -n_basis 32 -dec_nconv 2 --device cpu
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
import time

import numpy as np
import torch

from coarsegrainingvae_tpu_torch.config import ModelConfig
from coarsegrainingvae_tpu_torch.convert import save_params
from coarsegrainingvae_tpu_torch.data.sidechain import build_pcn_dataset
from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_protein
from coarsegrainingvae_tpu_torch.eval.metrics import bond_graphs_batch, graph_diff_ratio
from coarsegrainingvae_tpu_torch.models.cgvae import PCN, StochasticPCN
from coarsegrainingvae_tpu_torch.ops.geometry import drmsd
from coarsegrainingvae_tpu_torch.train.pcn_trainer import PCNTrainer
from coarsegrainingvae_tpu_torch.utils.logging import CSVLogger, annotate_job
from coarsegrainingvae_tpu_torch.utils.pdb import write_pdb


def load_protein_items(path: str, n: int, seed: int, scn_split: str = "train",
                       min_res: int = 6, max_res: int = 14,
                       well_posed: bool = False, device="cuda"):
    """Items = (seq, crd) tuples. Resolution: a pickle of
    {'seq': [...], 'crd': [...]} (the generate_pkl.py cache format), a raw
    SidechainNet dataset (a pickle of split dicts, or a CASP spec resolved
    by the sidechainnet package, run_pdb.py:265 of the original code), else
    synthetic stand-ins, relaxed on ``device`` when ``well_posed``."""
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            d = pickle.load(f)
        if "seq" in d:
            return list(zip(d["seq"], d["crd"]))[:n]
    if path:
        # raw SidechainNet dataset on disk, or a casp spec like "casp12"
        # resolved by the sidechainnet package; load_sidechainnet raises a
        # friendly have-these-splits error for a missing split either way
        from coarsegrainingvae_tpu_torch.data.sidechain import load_sidechainnet

        return load_sidechainnet(path, split=scn_split, n_data=n)
    rng = np.random.default_rng(seed)
    return [
        synthetic_protein(int(rng.integers(min_res, max_res)), seed=seed + i,
                          well_posed=well_posed, device=device)
        for i in range(n)
    ]


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-logdir", type=str, default="./run_pcn")
    p.add_argument("-data_pkl", type=str, default="",
                   help="protein source: generate_pkl cache, raw "
                        "SidechainNet pickle, or casp spec (needs "
                        "sidechainnet); empty -> synthetic stand-ins")
    p.add_argument("-scn_split", type=str, default="train",
                   help="split when -data_pkl is a SidechainNet dataset")
    p.add_argument("-ndata", type=int, default=64)
    p.add_argument("-n_basis", type=int, default=256)
    p.add_argument("-n_rbf", type=int, default=10)
    p.add_argument("-cutoff", type=float, default=10.0)
    p.add_argument("-dec_nconv", type=int, default=4)
    p.add_argument("-activation", type=str, default="swish")
    p.add_argument("-batch_size", type=int, default=4)
    p.add_argument("-nepochs", type=int, default=3)
    p.add_argument("-lr", type=float, default=1e-4)
    p.add_argument("-grad_clip", type=float, default=0.01,
                   help="grad-norm clip (reference utils.py:156 uses 0.01; "
                        "larger values train far faster on the recon-scale "
                        "losses of big proteins)")
    p.add_argument("-gamma", type=float, default=25.0)
    p.add_argument("-kappa", type=float, default=1.0)
    p.add_argument("-aux_warmup", type=int, default=0,
                   help="ramp the graph/dihedral loss weights 0->1 over "
                        "this many epochs (recon-first curriculum); 0 = "
                        "full loss from step 0 (reference behavior)")
    p.add_argument("-zeta", type=float, default=0.0,
                   help="excluded-volume hinge weight (repo extension, "
                        "losses.steric_loss_batched; 0 = reference loss)")
    p.add_argument("-steric_margin", type=float, default=0.3)
    p.add_argument("-zeta_warmup", type=int, default=0,
                   help="linear steric-weight ramp over the first N steps")
    p.add_argument("-seed", type=int, default=123)
    p.add_argument("-n_dump", type=int, default=4)
    p.add_argument("--dec_type", type=str, default="cross",
                   choices=["cross", "painn", "pseudo", "pseudo2"])
    p.add_argument("-patience", type=int, default=15)
    p.add_argument("-lr_patience", type=int, default=2)
    p.add_argument("-lr_factor", type=float, default=0.6)
    p.add_argument("-min_lr", type=float, default=1e-8)
    p.add_argument("--stochastic", action="store_true", default=False,
                   help="CVAE variant (StochasticPCN): per-residue latent "
                        "with a C-alpha-conditioned prior; eval reports "
                        "posterior-mean recon plus best-of-K prior samples "
                        "(repo extension, no reference analogue)")
    p.add_argument("-beta", type=float, default=0.05,
                   help="KL weight for --stochastic")
    p.add_argument("-n_ensemble", type=int, default=8,
                   help="prior samples per test protein for --stochastic "
                        "best-of-K scoring")
    p.add_argument("--bond_project", action="store_true", default=False,
                   help="depth-ordered covalent bond-length projection "
                        "rooted at the pinned C-alphas (repo extension, "
                        "models/cgvae.py::project_bonds_rooted; default "
                        "off = reference)")
    p.add_argument("--bond_project_eval", action="store_true", default=False,
                   help="apply the rooted bond projection ONLY on recon/"
                        "generate outputs, leaving the training objective "
                        "untouched (training through the projection is "
                        "unstable -- see examples/results/pcn_demo p7)")
    p.add_argument("--well_posed_data", action="store_true", default=False,
                   help="relax synthetic stand-in proteins against their "
                        "intended covalent topology so truth bond graphs "
                        "are trees and exact graph recovery (GED 0) is "
                        "achievable (synthetic.py::synthetic_protein); "
                        "default off = round-3/4 A/B data, which is ~40%% "
                        "cyclic")
    p.add_argument("-min_res", type=int, default=6,
                   help="synthetic stand-in protein length range")
    p.add_argument("-max_res", type=int, default=14)
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the run (default: the card)")
    return p


def model_config(a) -> ModelConfig:
    """The model config of the parsed flags ``a`` (also what reads the
    run's params.msgpack back)."""
    return ModelConfig(dec_type=a.dec_type, n_basis=a.n_basis, n_rbf=a.n_rbf,
                       atom_cutoff=a.cutoff, dec_nconv=a.dec_nconv, activation=a.activation)


def main(argv=None):
    a = build_parser().parse_args(argv)
    device = torch.device(a.device)
    logdir = annotate_job(f"pcn_ndata{a.ndata}", a.logdir, 0)
    os.makedirs(logdir, exist_ok=True)
    with open(os.path.join(logdir, "modelparams.json"), "w") as f:
        json.dump(vars(a), f, indent=2)

    items = load_protein_items(a.data_pkl, a.ndata, a.seed, a.scn_split,
                               a.min_res, a.max_res, a.well_posed_data, device)
    ds = build_pcn_dataset(items, cg_cutoff=a.cutoff)
    n = len(ds)
    n_test = max(n // 5, 1)
    n_val = max((n - n_test) // 10, 1)
    ds_test = ds.subset(np.arange(n_test))
    ds_val = ds.subset(np.arange(n_test, n_test + n_val))
    ds_tr = ds.subset(np.arange(n_test + n_val, n))

    cfg = model_config(a)
    gen = torch.Generator().manual_seed(a.seed)
    model = StochasticPCN(cfg, generator=gen) if a.stochastic else PCN(cfg, generator=gen)
    trainer = PCNTrainer(model, gamma=a.gamma, kappa=a.kappa, lr=a.lr,
                         grad_clip=a.grad_clip, seed=a.seed,
                         aux_warmup=a.aux_warmup, zeta=a.zeta,
                         steric_margin=a.steric_margin,
                         zeta_warmup=a.zeta_warmup,
                         bond_project=a.bond_project,
                         bond_project_eval=a.bond_project_eval,
                         beta=a.beta if a.stochastic else 0.0, device=device)
    state = trainer.init_state()

    logger = CSVLogger(os.path.join(logdir, "train_log.csv"))
    state, hist = trainer.fit(
        state, ds_tr, ds_val, a.nepochs, a.batch_size, log_fn=logger.log,
        patience=a.patience, lr_patience=a.lr_patience,
        lr_factor=a.lr_factor, min_lr=a.min_lr,
    )

    # the best-val parameters as flax msgpack in JAX's tree (run_pcn.py:179-183)
    save_params(os.path.join(logdir, "params.msgpack"), state.params, cfg)

    # per-protein test metrics (run_pdb.py:33-75)
    results = CSVLogger(os.path.join(logdir, "test_results.csv"))
    rows = []
    for i in range(len(ds_test)):
        idx = np.array([i])
        b = ds_test.batch(idx)
        cam = ds_test.ca_mask_for(idx)
        t0 = time.time()
        recon = trainer.reconstruct(b, cam).cpu().numpy().reshape(
            b.z.shape[0], b.z.shape[1], 3)[0]
        infer_s = time.time() - t0
        mask = b.atom_mask[0].numpy()
        true = b.xyz[0].numpy()
        z = b.z[0].numpy()
        rmsd = float(np.sqrt(((recon - true) ** 2).sum(-1)[mask].mean()))
        dr = float(drmsd(torch.as_tensor(recon[mask]), torch.as_tensor(true[mask])))
        g_true = bond_graphs_batch(true[None, mask], z[mask])[0]
        g_rec = bond_graphs_batch(recon[None, mask], z[mask])
        ged = float(graph_diff_ratio(g_true, g_rec)[0])
        row = {"protein": i, "seq_len": len(ds_test.seqs[i]), "rmsd": rmsd,
               "drmsd": dr, "ged": ged, "inference_s": infer_s}
        if a.stochastic:
            # best-of-K prior samples: how much of the deterministic RMSD
            # floor is rotamer multi-modality
            ens = trainer.sample_ensemble(b, cam, a.n_ensemble, seed=a.seed + i
                                          ).cpu().numpy().reshape(a.n_ensemble, -1, 3)
            er = np.sqrt(((ens - true[None]) ** 2).sum(-1)[:, mask].mean(-1))
            row["sample_best_rmsd"] = float(er.min())
            row["sample_mean_rmsd"] = float(er.mean())
        rows.append(row)
        results.log(row)
        if i < a.n_dump:
            write_pdb(
                os.path.join(logdir, f"recon_{i}.pdb"), ds_test.seqs[i],
                recon[mask], b.mapping[0].numpy()[mask], b.channel_idx[0].numpy()[mask],
            )
    return rows


if __name__ == "__main__":
    main()
