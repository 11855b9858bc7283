"""The benchmark's chignolin configuration (``chignolin_dense``, the cell
``chig_dense.train_b16``) against the benchmark's plain reference
(``benchmark/cgbench/reference/``), which imports nothing of the port.

On the CPU, at a small width: the port's training step on the
configuration (``DenseCGVAE`` with the cross decoder, the steric term on
its ramp) holds its loss, every leaf's gradient and one clipped-Adam update
to the reference's in f32, at step 0 (steric weight 0) and past
``zeta_warmup`` (full weight). The configuration loads through the
harness's ``experiment`` with no refused key, its stored mapping has 6
beads, and the traffic's frames are free of clashes. On a card
(``gpu``-marked), the same step at the published widths, TF32 off.
"""
import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

from cgbench import frames as fr  # noqa: E402
from cgbench import program  # noqa: E402
from cgbench import weights as wt  # noqa: E402
from cgbench.programs.dense import Program  # noqa: E402
from cgbench.reference import steric as ref_steric  # noqa: E402
from cgbench.reference import train as ref_train  # noqa: E402

from coarsegrainingvae_tpu_torch.eval.metrics import bond_cutoff_matrix  # noqa: E402

CONFIG = json.loads((BENCH / "configs" / "full_width" / "chignolin_dense.json").read_text())
TRAFFIC = json.loads((BENCH / "traffic" / "train_b16.json").read_text())
F32 = {"compute_dtype": "float32", "adam_moment_dtype": "float32"}
# n_basis 64: the channel lift needs n_basis >= the largest bead (56 atoms)
SMALL = {"n_basis": 64, "n_rbf": 4, "enc_nconv": 2, "dec_nconv": 2}
# at the small width the drawn weights at full scale put the KL term near
# 1e4 and the decoded atoms far apart, where the steric hinge reads 0; at
# half scale every term of the loss is of order 1-100
SMALL_WEIGHT_SCALE = 0.5


def _weights(cfg, seed, device, scale=1.0):
    with torch.device("meta"):
        spec = wt.leaves(ref_train.family(cfg["model"]).Model(cfg))
    return {k: v * scale for k, v in wt.draw(spec, seed, device).items()}


def _gaps(cfg, rows, step, device, seed=5, scale=1.0):
    """The port's step and the reference's from the same weights, frames,
    rows and noise, at optimizer step ``step``: (port, reference), each
    {"loss", "grads": {leaf: tensor}, "change": {leaf: norm}}, the port's
    also its unweighted "steric" hinge."""
    traffic = dict(TRAFFIC, batch_size=len(rows))
    frames = fr.make_frames(cfg["molecule"], traffic["frames"], 2 * len(rows), seed)
    weights = _weights(cfg, seed, device, scale)
    noise = 1234 + seed

    prog = Program(cfg, traffic, frames, weights, device)
    tr, state = prog.trainer, prog.state
    state.step.fill_(step)
    batch = prog.dds.gather(torch.as_tensor(rows, device=device))
    loss, metrics, grads = tr.loss_and_grads(state, batch,
                                             torch.Generator(device=device).manual_seed(noise))
    start = {n: p.detach().clone() for n, p in state.params.items()}
    new, ok = tr.apply_gradients(state, loss, grads)
    assert bool(ok)
    port = {"loss": float(loss), "steric": float(metrics["steric"]),
            "grads": dict(zip(state.params, (g.detach() for g in grads))),
            "change": {n: float(torch.linalg.vector_norm((p.detach() - start[n]).double()))
                       for n, p in new.params.items()}}
    prog.release()

    model = ref_train.build_model(cfg, device, weights)
    mol = ref_train.Molecule(cfg, device)
    rbatch = mol.batch(frames, np.asarray(rows))
    tables = tuple(torch.as_tensor(t, device=device) for t in ref_steric.tables(
        cfg["molecule"]["z"], cfg["molecule"]["bonds"], margin=cfg["steric_margin"]))
    zeta = cfg["zeta"] * min(step / cfg["zeta_warmup"], 1.0)
    out = model(rbatch, torch.Generator(device=device).manual_seed(noise))
    ref_loss = ref_train.vae_loss(out, rbatch.bonds, cfg["beta"], cfg["gamma"], zeta, tables)
    names, params = zip(*model.named_parameters())
    ref_grads = torch.autograd.grad(ref_loss, params, allow_unused=True)
    # the reference's update: its one-step readings, with the steric weight
    # and the learning rate that the ramps give at ``step``
    warm = cfg.get("lr_warmup", 0)
    lr = cfg["lr_per_sample"] * len(rows) * (min((step + 1) / warm, 1.0) if warm else 1.0)
    read = ref_train.readings(dict(cfg, zeta_warmup=0, zeta=zeta, lr_warmup=0), frames,
                              [np.asarray(rows)], lr, noise, weights, device)
    assert read["losses"][0] == pytest.approx(float(ref_loss.detach()), rel=1e-6)
    ref = {"loss": float(ref_loss.detach()),
           "grads": {n: torch.zeros_like(p) if g is None else g for n, p, g in
                     zip(names, params, ref_grads)},
           "change": dict(zip(read["names"], read["change_norms"].tolist()))}
    return port, ref


def _small():
    return dict(CONFIG, **SMALL, **F32)


@pytest.mark.parametrize("step", [0, CONFIG["zeta_warmup"]], ids=["ramp-start", "past-ramp"])
def test_the_port_step_is_the_reference_step_in_f32(step):
    """At step 0 the steric weight is 0; past the ramp it is zeta (200),
    and the hinge it weighs is not 0 at this width."""
    port, ref = _gaps(_small(), [3, 0], step, "cpu", scale=SMALL_WEIGHT_SCALE)
    if step:
        assert CONFIG["zeta"] * port["steric"] > 1.0
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4, abs=1e-5)
    assert set(port["grads"]) == set(ref["grads"])
    for name, g in ref["grads"].items():
        torch.testing.assert_close(port["grads"][name], g, rtol=1e-4, atol=1e-5, msg=name)
    for name, norm in ref["change"].items():
        assert port["change"][name] == pytest.approx(norm, rel=1e-4, abs=1e-7), name


def test_the_configuration_loads_with_no_refused_key_and_six_beads():
    exp = program.experiment(CONFIG, TRAFFIC, {})
    m, t = exp.model, exp.train
    assert (m.n_cgs, m.n_basis, m.n_rbf, m.enc_nconv, m.dec_nconv) == (6, 600, 10, 2, 9)
    assert (m.dec_type, m.breaksym, m.atom_cutoff, m.cg_cutoff) == ("cross", False, 12.0, 25.0)
    assert (t.zeta, t.zeta_warmup, t.gamma, t.lr) == (200.0, 1000, 50.0, pytest.approx(3e-4))
    assert t.lr_warmup == 1000
    assert exp.data.batch_size == 16 and not exp.parallel.zero_optimizer
    mapping = np.asarray(CONFIG["molecule"]["mapping"])
    assert mapping.shape == (209,) and np.bincount(mapping).tolist() == [15, 27, 56, 54, 23, 34]
    assert len(CONFIG["molecule"]["rotatable"]) == 74
    # what the data gives: every ordered atom pair, every bead pair, in one bucket of 128
    assert CONFIG["max_atom_edges"] == -(-209 * 208 // 128) * 128
    assert CONFIG["max_cg_edges"] >= 6 * 5


@pytest.mark.parametrize("seed", [7, 2**31 + 7])
def test_the_traffics_frames_are_free_of_clashes(seed):
    """No nonbonded pair of any frame of the cell (16 x 100 frames) comes
    within its covalent cutoff 1.3 (r_i + r_j) (``eval/metrics.py``)."""
    mol = CONFIG["molecule"]
    frames = fr.make_frames(mol, TRAFFIC["frames"], 16 * 100, seed).astype(np.float64)
    z, bonds = np.asarray(mol["z"]), np.asarray(mol["bonds"])
    nonbonded = ~np.eye(len(z), dtype=bool)
    nonbonded[bonds[:, 0], bonds[:, 1]] = nonbonded[bonds[:, 1], bonds[:, 0]] = False
    cutoff = bond_cutoff_matrix(z)[nonbonded]
    worst = np.inf
    for lo in range(0, len(frames), 200):
        x = frames[lo:lo + 200]
        d = np.sqrt(((x[:, :, None] - x[:, None]) ** 2).sum(-1))[:, nonbonded]
        worst = min(worst, float((d / cutoff).min()))
    assert worst > 1.0


@pytest.mark.gpu
def test_the_port_step_at_the_published_widths_is_the_reference_step_on_card():
    """At the published widths (n_basis 600, n_rbf 10, enc 2 / dec 9, the
    cross decoder; kernels 1-2 on the card), f32, TF32 off, one step past
    the steric ramp, B 16: the loss within 1e-4 of the reference's, each
    leaf's gradient within 1e-4 of its max |ref| and each leaf's update
    norm within 1e-4 (the tolerance every f32 card step of the port is held
    to, chip_smoke.TRAIN_RTOL: kernels 1-2 sum the 43,472 pairs a frame in
    another order than the plain einsums)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(CONFIG, **F32)
    port, ref = _gaps(cfg, list(range(16)), cfg["zeta_warmup"], torch.device("cuda", 0))
    assert port["loss"] == pytest.approx(ref["loss"], rel=1e-4)
    for name, g in ref["grads"].items():
        err = float((port["grads"][name] - g).abs().max())
        assert err <= 1e-4 * max(float(g.abs().max()), 1e-30), (name, err)
    for name, norm in ref["change"].items():
        assert port["change"][name] == pytest.approx(norm, rel=1e-4, abs=1e-9), name
