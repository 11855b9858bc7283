"""chip_smoke.py on the CPU: its roofline bounds against a hand count, its
cv phase rehearsed at a small width (the launch counts it expects against
the plain versions' calls), and its refusal to run without a card.

The script itself runs only on a GPU; these tests import it as a module
(it imports torch inside its functions) and check what needs no card.
"""
import argparse
import json

import pytest
import torch

import chip_smoke
from coarsegrainingvae_tpu_torch.utils import profiling

torch.set_num_threads(1)


# B 1, N 2, F 1, R 1 (two basis values), both nodes interacting: one
# unordered pair, 2 ordered ones. Counted by hand from the functions'
# least arithmetic (FMA = 2 FLOPs): K is symmetric, so the filters (and
# d_w) are counted once for the unordered pair, whatever kernel runs.
@pytest.mark.parametrize("kind,s,n_bytes,flops", [
    # floats: xyz 6 + mask 2; phi 6 + v 6 in, ds 2 + dv 6 out; w 6 -> 34.
    # per ordered pair: c1 one FMA (2), c0 and c2 a multiply and 3 FMAs (7
    # each) -> 16, times 2; the filters, 3 x 2 FMAs (12), once
    ("message", 3, 4 * 34, 2 * 16 + 12),
    # S = 4: per ordered pair 2 + 3 x 7 -> 23, times 2; the filters 4 x 2
    # FMAs (16) once; the receiver cross per node, 12, times 2. floats: 8;
    # phi 8 + v 6 in, 8 out; w 8 -> 38
    ("message", 4, 4 * 38, 2 * 23 + 16 + 2 * 12),
    # floats: 8; phi 8 + v 6 + gs 2 + gv 6 in, d_phi 8 + d_v 6 out; w 8 in
    # and d_w 8 out -> 60.
    # once: the filters 4 x 2 FMAs (16) and d_w, 4 adds phi_p t(q) +
    # phi_q t(p) and 4 x 2 FMAs (16) -> 36; per ordered pair: 4 multiplies
    # phi t, c1 2, c2 dot 5 + 2, c0 dot 5 + 2 + a_0 6, c3 dot 5 + 2 + a_3 6
    # + w3 6 -> 45, times 2; per node: phi_0 a_0 3, gv x v 9, phi_3 v 3,
    # phi_3 a_3 6, w3 x gv 9 + 3 -> 33, times 2
    ("message_vjp", 4, 4 * 60, 36 + 2 * 45 + 2 * 33),
    # floats: 8; phi 18 + s, sbar 4 + v, vbar 12 in; ds, dsbar 4 + dv, dvbar
    # 12 out; w 18 -> 76. once 9 x 2 FMAs (36), per ordered pair 64, per
    # node 57
    ("pseudo", 9, 4 * 76, 36 + 2 * 64 + 2 * 57),
    # floats: 8; in phi 18 + s, sbar 4 + v, vbar 12 + w 18, cotangents gs,
    # gsb 4 + gv, gvb 12; out d_phi 18 + d_s, d_sbar 4 + d_v, d_vbar 12 +
    # d_w 18 -> 128.
    # once: the filters 9 x 2 FMAs (36) and d_w, 9 adds phi_p dG(q, p) +
    # phi_q dG(p, q) and 9 x 2 FMAs (36) -> 81. Per ordered pair (receiver
    # i, sender j): 9 multiplies phi_j dG; dG_1 = gv_i . unit 5 and dG_2..8
    # = Gamma_i . x_j 7 x 5 (dG_0 = s_i gs_i is per node) -> 40; d_phi_j +=
    # filt dG, 9 FMAs (18); sender side d_x_j += g Gamma_i, 7 x 3 FMAs, g =
    # filt phi_j shared with the forward's sums but for channels 2 and 5
    # (2 multiplies) -> 44; the forward's sums s0 one FMA (2), a_3,4,6,7,8
    # a multiply and 3 FMAs each (35), t 3 FMAs (6) -> 43; the dsbar path
    # d_vbar_j += adj gsb_i v_i, a multiply and 3 FMAs (7) -> 161, times 2.
    # Per node: s gs 1; Gamma_3,7,8 crosses 3 x 9 and Gamma_4,6 3 x 3 -> 33;
    # d_s 1; d_sbar two dots 11; d_v += a_3 x gv + a_7 x gvb and d_vbar +=
    # a_8 x gvb, 3 x 12; d_v += gsb t 6 -> 88, times 2
    ("pseudo_vjp", 9, 4 * 128, 81 + 2 * 161 + 2 * 88),
])
def test_kernel_cost_matches_a_hand_count(kind, s, n_bytes, flops):
    assert profiling.kernel_cost(kind, 1, 2, s, 1, 1, pairs=2) == (n_bytes, flops)


def test_bound_takes_the_slower_resource():
    ms, by, resource = profiling.bound(3.35e9, 1)
    assert ms == pytest.approx(1.0) and (by, resource) == ("bytes", "HBM")
    ms, by, resource = profiling.bound(1, 67e9)
    assert ms == pytest.approx(1.0) and (by, resource) == ("operations", "FP32")
    # the encoder's message backward at B 128, N 27 (702 ordered pairs
    # each), F 600, R 8: 133 MB (0.040 ms) and 4.35 GFLOP, 351 unordered
    # pairs x 111 + 702 x 25 per frame and feature and 3 per node, bound
    # by the FP32 rate at 0.0649 ms
    n_bytes, flops = profiling.kernel_cost("message_vjp", 128, 27, 3, 600, 8, 128 * 702)
    assert flops == 600 * 128 * (351 * 111 + 702 * 25 + 27 * 3)
    ms, by, _ = profiling.bound(n_bytes, flops)
    assert by == "operations" and ms == pytest.approx(0.0649, abs=1e-4)


def test_smoke_run_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


@pytest.fixture
def counted_plain(monkeypatch):
    """The kernels launch nothing on the CPU, so each plain version's calls
    are counted in their place (a CUDA launch happens exactly where the
    wrapper would call them), through chip_smoke's reset/read of counts."""
    from coarsegrainingvae_tpu_torch.ops import fused_message as mo
    from coarsegrainingvae_tpu_torch.ops import fused_pseudo as po

    calls = dict.fromkeys(("fused_message", "fused_message_vjp", "fused_pseudo_message",
                           "fused_pseudo_vjp"), 0)
    for mod, attr, name in ((mo, "message_reference", "fused_message"),
                            (mo, "message_vjp_reference", "fused_message_vjp"),
                            (po, "pseudo_reference", "fused_pseudo_message"),
                            (po, "pseudo_vjp_reference", "fused_pseudo_vjp")):
        def counted(*args, _fn=getattr(mod, attr), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)

        monkeypatch.setattr(mod, attr, counted)
    monkeypatch.setattr(chip_smoke, "reset_counts", lambda: calls.update(dict.fromkeys(calls, 0)))
    monkeypatch.setattr(chip_smoke, "read_counts", lambda: dict(calls))
    return calls


SMALL_WIDTH = ["-n_basis", "16", "-n_rbf", "4", "-enc_nconv", "2", "-dec_nconv", "3",
               "-batch_size", "16"]


def test_cv_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain):
    """The cv phase's control flow and checks at a small width on the CPU,
    the plain versions' calls held to ``cv_expected_launches``."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))  # restored after
    width = SMALL_WIDTH
    paths = chip_smoke.cv(device="cpu", width=width, n_frames=90)
    assert paths["cv"] == chip_smoke.cv_expected_launches(
        width, 90, chip_smoke.CV_FOLDS, chip_smoke.CV_EPOCHS, chip_smoke.CV_EVALS, "pseudo")
    assert paths["cv_cross"] == chip_smoke.cv_expected_launches(
        width, 90, 1, 1, chip_smoke.CV_EVALS, "cross")
    assert min(paths["cv"].values()) > 0 and paths["cv_cross"]["fused_pseudo_message"] == 0
    assert (tmp_path / "chiprun_out" / "cv_data" / "dipeptide.npz").is_file()


def test_runfiles_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain, capsys):
    """The runfiles phase on a fold the cv phase trained at a small width:
    the state round trip, the converted fold served and resumed bit for
    bit; its counted launches are the converted request's (kernels 1 and
    3) and the resumed epoch's (1-4)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))  # restored after
    chip_smoke.cv(device="cpu", width=SMALL_WIDTH, n_frames=90)
    paths = chip_smoke.runfiles_phase(device="cpu")
    assert set(paths) == {"runfiles"} and min(paths["runfiles"].values()) > 0
    out = capsys.readouterr().out
    assert "every tensor bit for bit: True; re-written bytes identical: True" in out
    assert "bit for bit the original fold's: True" in out
    assert "parameters after bit for bit: True" in out
    assert (tmp_path / "build" / "runfiles_smoke" / "converted" / "fold0" / "ckpt").is_dir()


def test_cgae_phase_rehearses_on_the_cpu(monkeypatch):
    """The cgae phase's checks at a small depth on the CPU (both runs of the
    learn_map core on the CPU there: the same draws give the same logits)."""
    import coarsegrainingvae_tpu_torch.models.cgae as cgae

    calls = []
    real = cgae.learn_map

    def counted(*args, **kwargs):
        calls.append(kwargs.get("device"))
        return real(*args, **dict(kwargs, n_steps=60))

    monkeypatch.setattr(cgae, "learn_map", counted)
    chip_smoke.cgae_phase(device="cpu", n_frames=48, n_steps=60)
    assert calls and set(calls) == {"cpu"}


@pytest.mark.parametrize("sparse", [False, True], ids=["steric", "sparse"])
def test_steric_and_sparse_folds_rehearse_on_the_cpu(tmp_path, monkeypatch, counted_plain,
                                                     sparse):
    """The steric and sparse phases' CLI folds at a small width on the
    CPU: the dip_full_z100 recipe's flags plus --h_project_eval (the width
    flags given after them win), and the CV recipe with --sparse; each fold
    checked, served by from_run with 0 difference, and its plain calls held
    to ``cv_expected_launches`` (none for the sparse model)."""
    import numpy as np

    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    monkeypatch.chdir(tmp_path)
    n_frames = 90
    (tmp_path / "data").mkdir()
    save_npz_traj(str(tmp_path / "data" / "dipeptide.npz"),
                  *synthetic_peptide("dipeptide", n_frames=n_frames, seed=0, device="cpu"))
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "data"))
    depth = ["-ndata", str(n_frames), "-n_ensemble", "2", "-nevals", "2", "--graph_eval"]
    if sparse:
        args = chip_smoke.CV_RECIPE + SMALL_WIDTH + depth + ["--dec_type", "pseudo", "--sparse"]
    else:
        recipe = chip_smoke.recipe_flags("dip_full_z100")
        assert recipe[recipe.index("-zeta") + 1] == "100.0" and "--h_project_eval" not in recipe
        args = recipe + ["--h_project_eval"] + SMALL_WIDTH + depth
    launches = chip_smoke.cli_fold(args, "fold", "pseudo", SMALL_WIDTH, n_frames, 2, 2,
                                   sparse=sparse, device="cpu")
    want = chip_smoke.cv_expected_launches(SMALL_WIDTH, n_frames, 1, 2, 2, "pseudo")
    assert launches == (dict.fromkeys(want, 0) if sparse else want)
    assert min(want.values()) > 0
    (run,) = list((tmp_path / "build" / "cv_smoke").glob("fold*"))
    params = json.loads((run / "modelparams.json").read_text())
    assert params["model"]["sparse"] == sparse and params["model"]["n_basis"] == 16
    assert (params["train"]["zeta"] > 0) == params["model"]["h_project_eval"] == (not sparse)
    assert np.isfinite(float((run / "fold0" / "train_log.csv").read_text().splitlines()[-1]
                             .split(",")[2]))


def test_pcn_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain):
    """The pcn phase at a small width on the CPU: both recipes' runs and
    artifacts, the f32 step against itself, two steps from one state bit
    for bit, the timed steps; no kernel's plain version is called."""
    monkeypatch.chdir(tmp_path)
    width = ("-n_basis", "16", "-n_rbf", "4", "-dec_nconv", "1", "-batch_size", "2",
             "-min_res", "6", "-max_res", "10", "-n_ensemble", "2")
    paths = chip_smoke.pcn_phase(device="cpu", ndata=10, epochs=2, steps=2, width=width)
    assert set(paths) == {"pcn_p7", "pcn_p7s"}
    assert all(v == 0 for counts in paths.values() for v in counts.values())
    flags = chip_smoke.pcn_flags("p7s")
    assert "--stochastic" in flags and flags[flags.index("-n_basis") + 1] == "256"
    assert sorted(p.name.split("_")[0] for p in (tmp_path / "build" / "pcn_smoke").iterdir()) \
        == ["p7", "p7s"]


def test_covid_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain):
    """The covid phase's fold at a small size on the CPU: the covid2
    recipe's flags (sparse, degree_norm, seqpartition, cross decoder, batch
    2) with a small dataset and width given after them, the cell list and
    the bond diff forced by lowering their thresholds."""
    import functools

    from coarsegrainingvae_tpu_torch.data import neighbors
    from coarsegrainingvae_tpu_torch.eval import metrics, sampling

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "no_data"))
    monkeypatch.setattr(neighbors, "CELL_LIST_MIN_ATOMS", 1)
    monkeypatch.setattr(sampling, "evaluate_samples",
                        functools.partial(metrics.evaluate_samples, large_n_threshold=1))
    flags = chip_smoke.recipe_flags("covid2", chip_smoke.COVID_RECIPE)
    for flag in ("--sparse", "--degree_norm"):
        assert flag in flags
    assert flags[flags.index("-batch_size") + 1] == "2"
    width = ("-dataset", "pentapeptide", "-n_cgs", "12", "-n_basis", "64", "-n_rbf", "4",
             "-enc_nconv", "1", "-dec_nconv", "1")
    paths = chip_smoke.covid_phase(device="cpu", width=width)
    assert paths["covid"] == dict.fromkeys(paths["covid"], 0)
    (run,) = list((tmp_path / "build" / "cv_smoke").glob("covid*"))
    params = json.loads((run / "modelparams.json").read_text())
    assert params["model"]["sparse"] and params["model"]["degree_norm"]
    assert params["data"]["cg_method"] == "seqpartition"


def test_native_phase_rehearses_on_the_cpu(monkeypatch, capsys):
    """The native phase's checks on the CPU, with the pentapeptide standing
    in for the covid frames and the bond diff's threshold lowered below its
    atoms."""
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    monkeypatch.setattr(chip_smoke, "BOND_DIFF_THRESHOLD", 1)
    monkeypatch.setattr(chip_smoke, "covid_frames", lambda device, n: (
        synthetic_peptide("pentapeptide", n_frames=n, seed=0, device="cpu"), 0.0))
    chip_smoke.native_phase(device="cpu", covid_n_frames=3)
    out = capsys.readouterr().out
    assert out.count("mask and edges per receiver equal: True") == 2
    assert out.count("equal on those: True") == 2


def test_diffpool_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain, capsys):
    """The diffpool phase at a small width on the CPU: the v6 recipe's
    flags (graph_grad, zeta, h_project, sample_hard) through run_diffpool
    and every file, the step against the CPU's own (and float64), two steps
    bit for bit, the timed steps; no kernel's plain version is called."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))  # restored after
    width = ("-num_features", "16", "-n_rbf", "4", "-n_cgs", "4", "-batch_size", "4")
    paths = chip_smoke.diffpool_phase(device="cpu", ndata=24, epochs=1, pretrain=1, steps=2,
                                      width=width)
    assert paths == {"diffpool": dict.fromkeys(counted_plain, 0)}
    flags = chip_smoke.json_recipe_flags(chip_smoke.DIFFPOOL_RECIPE / "v6_modelparams.json")
    for flag in ("--graph_grad", "--h_project", "--sample_hard"):
        assert flag in flags
    assert flags[flags.index("-num_features") + 1] == "512"
    out = capsys.readouterr().out
    assert "bit for bit: True" in out and "ndata 2000 -> 24" in out
    (run,) = list((tmp_path / "build" / "diffpool_smoke").glob("v6_*"))
    assert (run / "fold1" / "params.msgpack").is_file()


def test_baseline_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain, capsys):
    """The baseline phase on the CPU: the baseline_demo recipe through
    run_baseline, every zoo entry's step against the CPU's own, the timed
    steps; no kernel's plain version is called."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))
    paths = chip_smoke.baseline_phase(device="cpu", ndata=24, epochs=1, steps=2,
                                      width=("-batch_size", "4"))
    assert paths == {"baseline": dict.fromkeys(counted_plain, 0)}
    out = capsys.readouterr().out
    assert all(f"{name} 0.000e+00" in out for name in ("linear", "setequimlp", "edgesetmlp"))


def _tiny_space(monkeypatch):
    from coarsegrainingvae_tpu_torch.cli import hpo

    monkeypatch.setattr(hpo, "CGVAE_SPACE", dict(
        hpo.CGVAE_SPACE, n_basis=("int", 8, 16), n_rbf=("int", 3, 4), enc_nconv=("int", 1, 2),
        dec_nconv=("int", 1, 2)))


HPO_SMALL = ("-ndata", "24", "-batch_size", "4", "-n_trials", "3", "-nepochs", "4")


def test_hpo_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain):
    """The hpo phase on the CPU with a narrow search space and a small
    budget: every trial runs, and the plain versions' calls equal the
    count worked out from the trials' configs."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))
    _tiny_space(monkeypatch)
    paths = chip_smoke.hpo_phase(device="cpu", width=HPO_SMALL)
    _, rows = chip_smoke.read_csv(chip_smoke.HPO_DIR / "hpo_asha_log.csv")
    assert len(rows) == 4 and {r["failed"] for r in rows} == {"False"}     # 3 trials, then 1
    a = argparse.Namespace(ndata=24, nsplits=2, batch_size=4, dec_type="cross")
    assert paths["hpo"] == chip_smoke.hpo_expected_launches(chip_smoke.HPO_DIR, rows, a)
    assert paths["hpo"]["fused_message"] > 0 and paths["hpo"]["fused_message_vjp"] > 0
    assert paths["hpo"]["fused_pseudo_message"] == 0
    assert paths["hpo_ranks"] == dict.fromkeys(chip_smoke.DENSE_PER_STEP, 0)  # none on the CPU
    _, one = chip_smoke.read_csv(chip_smoke.HPO_DIR / "one" / "hpo_asha_log.csv")
    _, ranks = chip_smoke.read_csv(chip_smoke.HPO_DIR / "ranks" / "hpo_asha_log.csv")
    assert len(ranks) == len(one) == 3                       # 2 trials, then the better


def test_hpo_phase_raises_on_a_failed_trial(tmp_path, monkeypatch, counted_plain):
    """A trial that raises is recorded as failed by the search, and the
    phase raises on it."""
    from coarsegrainingvae_tpu_torch.cli import run_cgvae

    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))
    _tiny_space(monkeypatch)
    real = run_cgvae.run_cv

    def flaky(cfg, **kw):
        if cfg.logdir.endswith("trial_0001"):
            raise RuntimeError("CUDA error: an illegal memory access was encountered")
        return real(cfg, **kw)

    monkeypatch.setattr(run_cgvae, "run_cv", flaky)
    with pytest.raises(RuntimeError, match="hpo trials failed.*illegal memory access"):
        chip_smoke.hpo_phase(device="cpu", width=HPO_SMALL)


def test_hpo_recipe_is_the_committed_demo():
    readme = (chip_smoke.DIFFPOOL_RECIPE.parent / "hpo_demo" / "README.md").read_text()
    command = readme.split("python -m coarsegrainingvae_tpu.cli.hpo", 1)[1].split("\n\n")[0]
    assert command.replace("\\", " ").split() == chip_smoke.HPO_RECIPE


def test_multigpu_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain, capsys):
    """The multigpu phase on the CPU at a tiny width: one gloo rank (in
    place of the card's NCCL rank) bit for bit with the plain trainer, the
    plain versions' calls of its epochs as counted; two spawned gloo ranks
    against the one-rank run, ZeRO-1 bit for bit the replicated optimizer;
    the halo stack on a 300-atom cloud against the unsharded stack."""
    import numpy as np

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    side = (300 / 0.05) ** (1 / 3)
    cloud = (rng.uniform(0, 1, (300, 3)) * np.array([3 * side, side, side])).astype(np.float32)
    paths = chip_smoke.multigpu_phase(
        device="cpu", batches=(8,), steps=2, n_frames=16, train_batch=8,
        model_kw=dict(n_basis=16, n_rbf=4, enc_nconv=1, dec_nconv=2),
        halo_frame=(cloud, 3.0, 4, "swish", 8))
    assert paths["multigpu"] == {"fused_message": 4, "fused_message_vjp": 4,
                                 "fused_pseudo_message": 4, "fused_pseudo_vjp": 4}
    out = capsys.readouterr().out
    assert "bit for bit True" in out and "ZeRO-1 against the replicated optimizer: bit for " \
        "bit True" in out
    assert out.count("multigpu rank ") == chip_smoke.MULTIGPU_RANKS
    assert "multigpu halo stack" in out


def test_tensor_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain, capsys):
    """The tensor phase on the CPU at a tiny width: two spawned gloo ranks
    on a (1, 2) mesh, every message block split on its half of the
    features, 3 f32 steps against the one-rank run; no launch on the CPU,
    where the wrappers run their plain versions."""
    monkeypatch.chdir(tmp_path)
    paths = chip_smoke.tensor_phase(
        device="cpu", n_frames=16, train_batch=8,
        model_kw=dict(n_basis=16, n_rbf=4, enc_nconv=1, dec_nconv=2))
    assert paths["tensor"] == dict.fromkeys(chip_smoke.DENSE_PER_STEP, 0)
    out = capsys.readouterr().out
    assert out.count("tensor rank ") == 2
    assert "features [(0, 8)] (F/m 8)" in out and "features [(8, 16)] (F/m 8)" in out


def test_learning_check_rehearses_on_the_cpu(tmp_path):
    """scripts/learning_check.py's demo recipe cut to a few CPU seconds:
    the flags parse, the run's files are collected and summarised."""
    import importlib.util
    from pathlib import Path

    spec = importlib.util.spec_from_file_location(
        "learning_check", Path(__file__).resolve().parents[1] / "scripts" / "learning_check.py")
    lc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(lc)
    rc = lc.main(["--which", "demo", "--rehearse", "--runs", str(tmp_path / "runs"),
                  "--out", str(tmp_path / "out")])
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    demo = summary["runs"]["demo"]
    assert rc == 0 and demo["rc"] == 0 and len(demo["folds"]) == 2
    assert "-n_basis 128" in demo["command"] and set(demo["epochs"]) == {"fold0", "fold1"}
    for name in ("cv_stats.csv", "modelparams.json", "fold0_train_log.csv"):
        assert (tmp_path / "out" / "demo" / name).is_file()



def test_examples_phase_rehearses_on_the_cpu(tmp_path, monkeypatch, counted_plain, capsys):
    """The examples phase's tools and checks on the CPU, narrow and cut in
    depth: every tool's rows, the census on the quickstart's recon, every
    kernel's plain version called on the path, the summary written."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path / "unused"))  # restored after
    paths = chip_smoke.examples_phase(device="cpu", kernel_f=4, n_basis=16, ab_n_basis=16,
                                      quick_ndata=200, kernel_steps=1, epochs=1,
                                      flagship_steps=1)
    assert set(paths) == {"examples"} and min(paths["examples"].values()) > 0
    summary = json.loads((tmp_path / "chiprun_out" / "examples_smoke.json").read_text())
    assert set(summary["seconds"]) == {"profile_kernels", "quickstart", "census",
                                       "accuracy_ab", "profile_flagship"}
    assert len(summary["results"]["profile_kernels"]) == 14
    assert summary["results"]["census"]["frames"] == 20
    assert (tmp_path / "build" / "examples_smoke" / "quickstart" / "ensemble.xyz").is_file()
    assert "examples: " in capsys.readouterr().out
