"""End-to-end quickstart on the PyTorch port: data -> mapping -> training ->
evaluation -> generative backmapping -> artifacts (``examples/quickstart.py``
through the port's Python API).

Runs on the card unless ``--device cpu`` is given. Drop a ``{name}.npz``
cache under $COARSEGRAININGVAE_DATA to use real trajectories instead of the
synthetic stand-in (relaxed on the device and cached).

    python examples/quickstart_torch.py [--device cuda]
"""
from __future__ import annotations

import argparse
import os
from types import SimpleNamespace

import numpy as np
import torch


def prepare(ndata: int = 400, device="cuda") -> SimpleNamespace:
    """Steps 1-2 of the original (quickstart.py:37-56): frames, the Girvan-
    Newman mapping, and the train, validation and test datasets."""
    from coarsegrainingvae_tpu_torch.data.dataset import build_dataset
    from coarsegrainingvae_tpu_torch.data.mappings import get_mapping
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames

    # 1. frames + a CG mapping (Girvan-Newman over the bond graph)
    z, frames, bonds = load_frames("dipeptide", ndata, seed=0, device=device)
    mapping = get_mapping("newman", 3, z.shape[0], bonds=bonds, frames=frames)

    # 2. preprocess once to fixed-shape arrays
    n_tr = int(ndata * 0.8)
    n_val = int(ndata * 0.1)
    kw = dict(atom_cutoff=8.5, cg_cutoff=9.5, atomic_nums=z, bonds=bonds, order=2, seed=0)
    ds_tr = build_dataset(mapping, frames[:n_tr], **kw)
    lim = dict(max_atom_edges=ds_tr.nbrs.shape[1], max_cg_edges=ds_tr.cg_nbrs.shape[1])
    ds_val = build_dataset(mapping, frames[n_tr:n_tr + n_val], rotate=False, **lim, **kw)
    ds_te = build_dataset(mapping, frames[n_tr + n_val:], rotate=False, **lim, **kw)
    return SimpleNamespace(z=z, frames=frames, bonds=bonds, mapping=mapping, train=ds_tr,
                           val=ds_val, test=ds_te)


def config():
    """The original's ExperimentConfig (quickstart.py:59-65)."""
    from coarsegrainingvae_tpu_torch.config import (DataConfig, ExperimentConfig,
                                                    ModelConfig, TrainConfig)

    return ExperimentConfig(
        model=ModelConfig(n_cgs=3, n_basis=128, n_rbf=8, atom_cutoff=8.5, cg_cutoff=9.5,
                          enc_nconv=2, dec_nconv=3, dec_type="pseudo", breaksym=True),
        data=DataConfig(batch_size=32, seed=0),
        train=TrainConfig(lr=3e-4, beta=0.05, gamma=25.0),
    )


def run(out_dir: str = "./quickstart_out", ndata: int = 400, nepochs: int = 20,
        device="cuda") -> SimpleNamespace:
    """Every step of the original; returns the data, the trainer, the
    history, the test reconstructions, the prior samples and the backmapped
    ensemble."""
    from coarsegrainingvae_tpu_torch.eval.sampling import reconstruct_all, sample_ensemble
    from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
    from coarsegrainingvae_tpu_torch.serve import Backmapper
    from coarsegrainingvae_tpu_torch.train.trainer import Trainer
    from coarsegrainingvae_tpu_torch.utils.visualization import save_rotate_frames

    os.makedirs(out_dir, exist_ok=True)
    data = prepare(ndata, device)

    # 3. train (on the card each epoch replays one captured step on
    # device-resident data)
    cfg = config()
    trainer = Trainer(DenseCGVAE(cfg.model, generator=torch.Generator().manual_seed(0)), cfg,
                      device=device)
    state = trainer.init_state(data.train.batch(np.arange(32)))
    state, history = trainer.fit(state, data.train, data.val, nepochs=nepochs)
    print(f"trained {len(history)} epochs; val recon {history[-1]['val_recon']:.3f}")

    # 4. evaluate: reconstruction RMSD + prior-ensemble sampling quality
    recon = reconstruct_all(trainer, data.test, seed=0, batch_size=32, graph_eval=True)
    print(f"test all-atom RMSD {recon['all_atom_rmsd']:.3f} A, "
          f"heavy {recon['heavy_atom_rmsd']:.3f} A")
    samples = sample_ensemble(trainer, data.test, np.arange(4), n_sample=8, seed=1,
                              graph_eval=True)

    # 5. generative backmapping of NEW CG coordinates through the serving API
    bm = Backmapper(trainer.model, data.mapping, data.z, cfg, device=device)
    ensemble = bm.backmap(np.asarray(data.test.cg_xyz[0]), n_samples=8, seed=3)
    print(f"backmapped ensemble: {ensemble.shape}")

    # 6. artifacts: rotating-grid movie of the generated ensemble
    save_rotate_frames(ensemble, data.z, os.path.join(out_dir, "ensemble.xyz"))
    print(f"wrote {out_dir}/ensemble.xyz")
    return SimpleNamespace(data=data, trainer=trainer, history=history, recon=recon,
                           samples=samples, ensemble=ensemble)


def main(out_dir: str = "./quickstart_out", ndata: int = 400, nepochs: int = 20,
         device="cuda") -> dict:
    res = run(out_dir, ndata, nepochs, device)
    return {"rmsd": res.recon["all_atom_rmsd"], "ensemble": res.ensemble.shape}


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    main(device=p.parse_args().device)
