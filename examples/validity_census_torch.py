"""Bond-graph validity failure census for a finished run, on the PyTorch
port's metrics (``examples/validity_census.py``).

Answers "WHY is exact-match validity low?" by splitting every wrong edge
in the reconstructed structures into the two possible failure modes and
ranking the recurring atom pairs:

  missing covalent bond  — a bonded pair reconstructed OUTSIDE the
                           1.3x-covalent cutoff (eval/metrics.py)
  spurious contact       — a nonbonded pair reconstructed INSIDE it

Host numpy over ``eval/metrics.py`` and ``utils/xyz.py``. The frames come
from ``data.proteins.load_frames``: an npz under $COARSEGRAININGVAE_DATA,
else the synthetic stand-in's cache, else synthetic frames relaxed on the
card.

Usage:
    python examples/validity_census_torch.py \\
        -xyz /path/to/fold0/test_recon.xyz -dataset chignolin \\
        [-ndata 5000] [-seed 123] [-top 12]
"""
from __future__ import annotations

import argparse
import json

import numpy as np

_ELEM = {1: "H", 6: "C", 7: "N", 8: "O", 16: "S"}


def census(recon, z, bonds, top=12):
    from coarsegrainingvae_tpu_torch.eval.metrics import bond_graphs_batch

    n = z.shape[0]
    ref = np.zeros((n, n), np.int8)
    for a, b in np.asarray(bonds).reshape(-1, 2):
        ref[a, b] = ref[b, a] = 1
    gen = bond_graphs_batch(recon, z)
    heavy = z != 1
    diff = gen != ref[None]

    def lab(i):
        # single-letter fallback keeps the digits = atom index invariant
        # that data_margins' idx() parser relies on
        return f"{_ELEM.get(int(z[i]), 'X')}{i}"
    out = {
        "frames": int(recon.shape[0]),
        "all_valid_ratio": float((diff.sum((1, 2)) == 0).mean()),
        "heavy_valid_ratio": float(
            (diff[:, heavy][:, :, heavy].sum((1, 2)) == 0).mean()
        ),
    }
    miss = ((gen == 0) & (ref[None] == 1)).mean(0)
    spur = ((gen == 1) & (ref[None] == 0)).mean(0)

    def _top(mat, heavy_only=False):
        m = mat.copy()
        if heavy_only:
            m[~heavy] = 0
            m[:, ~heavy] = 0
        iu = np.triu_indices(n, 1)
        vals = m[iu] * 2.0  # symmetric matrix -> per-pair frequency
        order = np.argsort(vals)[::-1][:top]
        return [
            (lab(iu[0][o]), lab(iu[1][o]), round(float(vals[o]), 3))
            for o in order
            if vals[o] > 0
        ]

    out["missing_covalent"] = _top(miss)
    out["spurious_contacts"] = _top(spur)
    out["heavy_spurious_contacts"] = _top(spur, heavy_only=True)
    per_frame_heavy = diff[:, heavy][:, :, heavy].sum((1, 2)) // 2
    out["heavy_wrong_edges_pct"] = np.percentile(
        per_frame_heavy, [0, 25, 50, 75, 100]
    ).tolist()
    return out


def data_margins(frames, z, bonds, pairs):
    """True-ensemble distance margin above the validity cutoff for the
    given (a, b) pairs — distinguishes 'the data is tight there' from
    'the model compresses it'."""
    from coarsegrainingvae_tpu_torch.eval.metrics import bond_cutoff_matrix

    cut = bond_cutoff_matrix(z)
    d = np.sqrt(
        ((frames[:, :, None, :] - frames[:, None, :, :]) ** 2).sum(-1)
    )

    def idx(label):  # "C67" -> 67 (census labels are element+index)
        return int("".join(c for c in str(label) if c.isdigit()))

    out = {}
    for a, b, _ in pairs:
        i, j = idx(a), idx(b)
        out[f"{a}-{b}"] = round(float(np.median(d[:, i, j]) - cut[i, j]), 3)
    return out


def main(argv=None) -> dict:
    from coarsegrainingvae_tpu_torch.data.proteins import load_frames
    from coarsegrainingvae_tpu_torch.utils.xyz import read_xyz

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("-xyz", required=True, help="xyz dump (e.g. test_recon.xyz)")
    p.add_argument("-dataset", default="chignolin")
    p.add_argument("-ndata", type=int, default=5000)
    p.add_argument("-seed", type=int, default=123)
    p.add_argument("-top", type=int, default=12)
    a = p.parse_args(argv)

    z, frames, bonds = load_frames(a.dataset, a.ndata, seed=a.seed)
    _, recon = read_xyz(a.xyz)
    rep = census(np.asarray(recon), z, bonds, top=a.top)
    rep["data_margin_median_A"] = data_margins(
        frames[:200], z, bonds, rep["heavy_spurious_contacts"]
    )
    print(json.dumps(rep, indent=2))
    return rep


if __name__ == "__main__":
    main()
