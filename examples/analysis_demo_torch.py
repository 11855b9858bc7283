"""Post-hoc analysis demo on the PyTorch port: the TICA free-energy landscape
and the Ramachandran angles of a finished fold.

The path of ``examples/analysis_demo.py`` on the port: reload a trained fold
(``cli.postanalysis.reevaluate``), project the true and generated ensembles
into the shared TICA space, draw both KDE free-energy surfaces, then the
backbone (phi, psi) angles of both ensembles and their free energy. The
quads come from the dataset's atom names when its npz carries them;
otherwise (the synthetic stand-in has none) the two middle dihedrals of the
longest heavy-atom bond path stand in for phi and psi.

    python examples/analysis_demo_torch.py \
        -modelparams <run>/modelparams.json -logdir <run>/fold0 \
        -out examples/results/analysis_demo_torch

A fold that JAX trained reads the same way once ``scripts/convert_run.py
--to torch`` has converted it. ``--device`` defaults to the card.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np


def heavy_path_quads(z: np.ndarray, bonds: np.ndarray) -> np.ndarray:
    """(2, 4) dihedral quads along the longest heavy-atom bond path (a
    tree diameter by two breadth-first searches): its two middle ones."""
    heavy = set(int(i) for i in np.flatnonzero(np.asarray(z) > 1))
    nbrs = {i: [] for i in heavy}
    for a, b in np.asarray(bonds).reshape(-1, 2):
        if int(a) in heavy and int(b) in heavy:
            nbrs[int(a)].append(int(b))
            nbrs[int(b)].append(int(a))

    def farthest(start):
        parent, order = {start: None}, [start]
        for node in order:
            for nb in sorted(nbrs[node]):
                if nb not in parent:
                    parent[nb] = node
                    order.append(nb)
        path, node = [], order[-1]
        while node is not None:
            path.append(node)
            node = parent[node]
        return path

    path = farthest(farthest(min(heavy))[0])
    if len(path) < 5:
        raise ValueError("the heavy-atom backbone is too short for two dihedrals")
    mid = (len(path) - 5) // 2
    return np.asarray([path[mid:mid + 4], path[mid + 1:mid + 5]], np.int32)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-modelparams", required=True)
    p.add_argument("-logdir", required=True)
    p.add_argument("-out", default="examples/results/analysis_demo_torch")
    p.add_argument("-nevals", type=int, default=36)
    p.add_argument("-n_ensemble", type=int, default=16)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)

    from coarsegrainingvae_tpu_torch.cli.postanalysis import reevaluate
    from coarsegrainingvae_tpu_torch.config import ExperimentConfig
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames, load_traj_atom_names
    from coarsegrainingvae_tpu_torch.eval.analysis import (
        phi_psi_quads,
        plot_free_energy,
        ramachandran,
    )

    res = reevaluate(a.modelparams, a.logdir, graph_eval=True, n_ensemble=a.n_ensemble,
                     nevals=a.nevals, device=a.device, keep_xyz=True)
    os.makedirs(a.out, exist_ok=True)
    true_t, gen_t = np.asarray(res["tica_true"]), np.asarray(res["tica_gen"])
    plot_free_energy(true_t[:, 0], true_t[:, 1], os.path.join(a.out, "free_energy_true.png"))
    plot_free_energy(gen_t[:, 0], gen_t[:, 1], os.path.join(a.out, "free_energy_generated.png"))

    cfg = ExperimentConfig.load(a.modelparams)
    names = load_traj_atom_names(cfg.data.dataset)
    z, _, bonds = load_frames(cfg.data.dataset, 1, seed=cfg.data.seed, device=a.device)
    if names is not None:
        with open(os.path.join(a.logdir, "mapping.json")) as f:
            residues = np.asarray(json.load(f))
        phi_q, psi_q = phi_psi_quads(names, residues)
        source = "atom names"
    else:
        phi_q, psi_q = (q[None] for q in heavy_path_quads(z, bonds))
        source = "heavy-atom path"
    angles = {}
    for label, key in (("true", "true_xyzs"), ("generated", "sample_xyzs")):
        phi, psi = ramachandran(res[key], phi_q, psi_q, device=a.device)
        angles[label] = (phi[:, 0], psi[:, 0])
        plot_free_energy(phi[:, 0], psi[:, 0],
                         os.path.join(a.out, f"ramachandran_{label}.png"))
    np.savez(os.path.join(a.out, "projections.npz"), tica_true=true_t, tica_gen=gen_t,
             phi_true=angles["true"][0], psi_true=angles["true"][1],
             phi_gen=angles["generated"][0], psi_gen=angles["generated"][1])

    summary = {k: v for k, v in res.items()
               if not k.startswith("tica") and not k.endswith("xyzs")}
    summary.update(quads_from=source, phi_quad=phi_q[0].tolist(), psi_quad=psi_q[0].tolist(),
                   n_true=int(len(true_t)), n_generated=int(len(gen_t)))
    with open(os.path.join(a.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print(json.dumps(summary, indent=2))
    return summary


if __name__ == "__main__":
    main()
