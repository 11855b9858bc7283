"""Accuracy A/B harness on the PyTorch port: train the dense flagship under
two (or more) configurations on identical data and seeds and compare the
held-out reconstruction RMSD (``examples/accuracy_ab.py``).

The gate behind the two bf16 defaults (``compute_dtype``,
``adam_moment_dtype``). Each variant: 810 train / 90 validation / 200 test
synthetic dipeptide frames, n_basis 128, enc 2 / dec 3, pseudo decoder,
breaksym, parameters drawn from seed 123, 60 epochs through ``Trainer.fit``
(on the card each epoch replays the captured step), then
``reconstruct_all`` on the test frames. Prints one JSON line per variant.

Variant grammar: '+'-joined tokens, first = compute_dtype:
  float32 | bfloat16           matmul dtype
  +bf16adam                    Adam moments stored bfloat16
  +b<NN>                       batch size NN, LR scaled linearly by NN/32

Usage:
  python examples/accuracy_ab_torch.py \\
      --variants bfloat16,bfloat16+bf16adam,bfloat16+bf16adam+b64 [--device cuda]
"""
from __future__ import annotations

import argparse
import json
from types import SimpleNamespace

import numpy as np
import torch

N_FRAMES = 1100
SPLITS = ((0, 810), (810, 900), (900, 1100))


def parse_variant(variant: str) -> tuple:
    """(compute_dtype, adam_moment_dtype, batch size) of a variant; raises
    on a token the grammar lacks."""
    toks = variant.split("+")
    adam_dtype, batch = "float32", 32
    for tok in toks[1:]:
        if tok == "bf16adam":
            adam_dtype = "bfloat16"
        elif tok.startswith("b") and tok[1:].isdigit():
            batch = int(tok[1:])
        else:
            raise ValueError(f"unknown variant token {tok!r}")
    return toks[0], adam_dtype, batch


def variant_config(variant: str, n_basis: int = 128):
    """The variant's ExperimentConfig (accuracy_ab.py:79-89)."""
    from coarsegrainingvae_tpu_torch.config import (DataConfig, ExperimentConfig,
                                                    ModelConfig, TrainConfig)

    dtype, adam_dtype, batch = parse_variant(variant)
    return ExperimentConfig(
        model=ModelConfig(
            n_cgs=3, n_basis=n_basis, n_rbf=8, atom_cutoff=8.5, cg_cutoff=9.5,
            enc_nconv=2, dec_nconv=3, activation="swish", dec_type="pseudo",
            breaksym=True, compute_dtype=dtype,
        ),
        data=DataConfig(batch_size=batch),
        train=TrainConfig(lr=3e-4 * batch / 32, beta=0.05, gamma=25.0, grad_clip=0.01,
                          adam_moment_dtype=adam_dtype),
    )


def ab_data(device="cuda") -> SimpleNamespace:
    """The original's frames, mapping, dataset and 810/90/200 split
    (accuracy_ab.py:56-65); the frames are relaxed on ``device``."""
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import newman_mapping
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=N_FRAMES, seed=0, device=device)
    mapping = newman_mapping(bonds, z.shape[0], 3, seed=0)
    ds = build_dataset(mapping, frames, atom_cutoff=8.5, cg_cutoff=9.5, atomic_nums=z,
                       bonds=bonds, order=2, rotate=True, seed=1)
    train, val, test = (ds.subset(np.arange(lo, hi)) for lo, hi in SPLITS)
    return SimpleNamespace(z=z, frames=frames, bonds=bonds, mapping=mapping, ds=ds,
                           train=train, val=val, test=test)


def variant_trainer(variant: str, data, device, n_basis: int = 128):
    """(trainer, state) of a variant: a DenseCGVAE drawn from seed 123."""
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer

    cfg = variant_config(variant, n_basis)
    tr = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(123)), cfg,
                 device=device)
    return tr, tr.init_state(data.train.batch(np.arange(32)))


def run_variant(variant: str, data, epochs: int, n_basis: int, device) -> dict:
    """Train one variant and read its test reconstructions: the output row."""
    from coarsegrainingvae_tpu_torch.eval.metrics import compute_rmsd_batch
    from coarsegrainingvae_tpu_torch.eval.sampling import reconstruct_all

    tr, state = variant_trainer(variant, data, device, n_basis)
    state, hist = tr.fit(state, data.train, data.val, nepochs=epochs)
    out = reconstruct_all(tr, data.test, seed=7, graph_eval=False)
    rmsd = np.stack([compute_rmsd_batch(out["recon_xyzs"][i:i + 1], out["true_xyzs"][i],
                                        data.z)[0] for i in range(len(data.test))])
    return {
        "variant": variant,
        "epochs_ran": len(hist),
        "final_val_recon": round(float(hist[-1]["val_recon"]), 4),
        "final_val_loss": round(float(hist[-1]["val_loss"]), 4),
        "test_rmsd_all_atom": round(float(rmsd[:, 0].mean()), 4),
        "test_rmsd_heavy": round(float(rmsd[:, 1].mean()), 4),
    }


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--variants", default="float32,bfloat16",
                   help="comma list of compute_dtype values to compare")
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--n_basis", type=int, default=128)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    variants = a.variants.split(",")
    for variant in variants:
        parse_variant(variant)
    data = ab_data(a.device)
    rows = []
    for variant in variants:
        row = run_variant(variant, data, a.epochs, a.n_basis, a.device)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


if __name__ == "__main__":
    main()
