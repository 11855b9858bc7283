"""The port's hyperparameter search against the JAX package's, on the CPU:
the same draws, rungs, rows, failures and trial names under stub
objectives, and one real trial through the port's ``run_cv`` at a tiny
width."""
import csv

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.cli import hpo as jhpo
from coarsegrainingvae_tpu.cli import run_cgvae as jrun_cgvae
from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu_torch.cli import hpo, run_cgvae
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj

torch.set_num_threads(1)

SPACE = dict(hpo.CGVAE_SPACE, act=("choice", ("swish", "ReLU", "Tanh"), None))


def _objective(cfg, epochs=2):
    """A deterministic stand-in: NaN for one region (a failed trial), an
    exception for another, else a smooth function of the draws."""
    if cfg["n_rbf"] == 12:
        raise RuntimeError("stub failure")
    if cfg["enc_nconv"] == 5:
        return float("nan")
    return cfg["lr"] * 1e3 + cfg["beta"] + cfg["n_basis"] / 600 + 1.0 / epochs


def _comparable(rows):
    """Rows without their wall seconds, NaN made comparable."""
    return [{k: ("nan" if isinstance(v, float) and np.isnan(v) else v)
             for k, v in r.items() if k != "wall_s"} for r in rows]


def _rows(path):
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        return reader.fieldnames, [{k: v for k, v in r.items() if k != "wall_s"} for r in reader]


@pytest.mark.parametrize("seed", [0, 7, 123])
def test_sample_config_draws_as_jax(seed):
    jr, tr = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(5):
        assert hpo.sample_config(SPACE, tr) == jhpo.sample_config(SPACE, jr)
    assert hpo.CGVAE_SPACE == jhpo.CGVAE_SPACE


def test_random_search_matches_jax(tmp_path):
    jbest, jval, jrows = jhpo.random_search(_objective, hpo.CGVAE_SPACE, 12, seed=3,
                                            log_path=str(tmp_path / "jax.csv"))
    tbest, tval, trows = hpo.random_search(_objective, hpo.CGVAE_SPACE, 12, seed=3,
                                           log_path=str(tmp_path / "port.csv"))
    assert (tbest, tval) == (jbest, jval)
    assert _comparable(trows) == _comparable(jrows)
    assert any(r["failed"] for r in trows) and any("error" in r for r in trows)
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "jax.csv")


@pytest.mark.parametrize("n_trials,reduction", [(6, 4), (9, 2)])
def test_asha_search_matches_jax(tmp_path, n_trials, reduction):
    kw = dict(min_epochs=1, max_epochs=8, reduction=reduction, seed=11)
    jbest, jval, jrows = jhpo.asha_search(_objective, hpo.CGVAE_SPACE, n_trials,
                                          log_path=str(tmp_path / "jax.csv"), **kw)
    tbest, tval, trows = hpo.asha_search(_objective, hpo.CGVAE_SPACE, n_trials,
                                         log_path=str(tmp_path / "port.csv"), **kw)
    assert (tbest, tval) == (jbest, jval)
    assert _comparable(trows) == _comparable(jrows)
    assert max(r["rung"] for r in trows) >= 1
    assert _rows(tmp_path / "port.csv") == _rows(tmp_path / "jax.csv")


@pytest.mark.parametrize("strategy", ["random", "asha"])
def test_main_names_trials_and_passes_configs_as_jax(tmp_path, monkeypatch, strategy):
    """Both CLIs with ``run_cv`` stubbed: the same trial directories in the
    same order, each with the same model and train fields; the port's
    trials run on ``--device``."""
    calls = {"jax": [], "port": []}

    def stub(key):
        def run_cv(cfg, n_ensemble=16, nevals=36, graph_eval=False, device=None, **kw):
            calls[key].append((cfg.logdir.rsplit("/", 1)[-1], cfg.model.n_basis,
                               cfg.model.enc_nconv, cfg.train.lr, cfg.train.nepochs,
                               n_ensemble, nevals, graph_eval, device))
            return [{"test_all_recon_rmsd": cfg.train.lr * 1e3 + cfg.model.n_basis / 600}]
        return run_cv

    monkeypatch.setattr(jrun_cgvae, "run_cv", stub("jax"))
    monkeypatch.setattr(run_cgvae, "run_cv", stub("port"))
    args = ["-strategy", strategy, "-n_trials", "5", "-nepochs", "8", "-seed", "7"]
    jbest = jhpo.main(args + ["-logdir", str(tmp_path / "jax")])
    tbest = hpo.main(args + ["-logdir", str(tmp_path / "port"), "--device", "cpu"])
    assert tbest == jbest
    assert [c[:-1] for c in calls["port"]] == [c[:-1] for c in calls["jax"]]
    assert [c[0] for c in calls["port"]][:2] == ["trial_0000", "trial_0001"]
    assert {c[-1] for c in calls["port"]} == {"cpu"}
    log = "hpo_log.csv" if strategy == "random" else "hpo_asha_log.csv"
    assert _rows(tmp_path / "port" / log) == _rows(tmp_path / "jax" / log)


def test_one_real_trial_through_run_cv(tmp_path, monkeypatch):
    """The CLI's objective at a tiny width: a real CV run of both folds on
    the CPU, its directory and a finite objective."""
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=32, seed=0)
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    p = run_cgvae.build_parser()
    args = p.parse_args(["-logdir", str(tmp_path / "hpo"), "-ndata", "32", "-batch_size", "8",
                         "-nsplits", "2", "-cg_method", "newman", "-nepochs", "1",
                         "--device", "cpu"])
    objective = hpo._cv_objective(args)
    value = objective(dict(lr=3e-4, beta=0.05, gamma=5.0, n_basis=16, n_rbf=4, enc_nconv=1,
                           dec_nconv=1, atom_cutoff=8.0, cg_cutoff=9.0), 1)
    assert np.isfinite(value) and value > 0
    run = tmp_path / "hpo" / "trial_0000"
    with open(run / "cv_stats.csv", newline="") as f:
        rows = list(csv.DictReader(f))
    assert len(rows) == 2                      # -max_folds does not reach the objective
    assert value == pytest.approx(np.mean([float(r["test_all_recon_rmsd"]) for r in rows]))


def _asha_rows(path):
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def test_torchrun_two_ranks_match_one_process(tmp_path, monkeypatch):
    """The hpo CLI under ``torch.distributed.run --nproc_per_node 2`` on the
    CPU (gloo): every trial trains data-parallel over both ranks. Rank 0
    alone writes: the run holds the one-process run's trial directories
    and hpo_asha_log.csv rows (two trials at 1 epoch, the better at 2),
    each value within 1e-3 (the default bf16 matmuls round each rank's
    half batch on its own), and each trial's cv_stats.csv one row per fold
    within 1e-3 (KL, a bf16 sum, within 1e-2)."""
    import os
    import subprocess
    import sys

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=32, seed=0)
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    args = ["-strategy", "asha", "-n_trials", "2", "-seed", "1764", "-ndata", "32",
            "-batch_size", "8", "-nsplits", "2", "-cg_method", "newman", "-nepochs", "2",
            "--device", "cpu"]
    hpo.main(args + ["-logdir", str(tmp_path / "one")])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "coarsegrainingvae_tpu_torch.cli.hpo", *args, "-logdir", str(tmp_path / "two")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    assert res.stdout.count("'best'") == 1                  # rank 0 alone prints
    one, two = tmp_path / "one", tmp_path / "two"
    assert sorted(p.name for p in two.iterdir()) == sorted(p.name for p in one.iterdir())
    got, want = _asha_rows(two / "hpo_asha_log.csv"), _asha_rows(one / "hpo_asha_log.csv")
    assert len(want) == 3 and [r["rung"] for r in want] == ["0", "0", "1"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            if k == "value":
                np.testing.assert_allclose(float(g[k]), float(w[k]), rtol=1e-3)
            elif k != "wall_s":
                assert g[k] == w[k], k
    for trial in sorted(p.name for p in one.iterdir() if p.name.startswith("trial_")):
        run_one, run_two = one / trial, two / trial
        assert sorted(p.name for p in run_two.iterdir()) == sorted(p.name for p in run_one.iterdir())
        rows_two, rows_one = (_asha_rows(r / "cv_stats.csv") for r in (run_two, run_one))
        assert len(rows_two) == len(rows_one) == 2
        for g, w in zip(rows_two, rows_one):
            for k, v in w.items():
                if k in ("fold", "epoch"):
                    assert g[k] == v
                elif k != "wall_s":
                    np.testing.assert_allclose(float(g[k]), float(v), err_msg=k,
                                               rtol=1e-2 if k == "KL" else 1e-3)


def test_a_trial_failing_on_one_rank_fails_on_every_rank(tmp_path):
    """A stub objective that raises on rank 1 alone: that trial is failed
    on both ranks, with rank 1's error, the other trials run on, and
    both searches finish on both ranks with the same rows; rank 0 alone
    logs them."""
    import torch_parallel_ranks as ranks

    from coarsegrainingvae_tpu_torch.parallel.launch import spawn_ranks

    (tmp_path / "logs").mkdir()
    res = spawn_ranks(ranks.hpo_failing_rank, 2, str(tmp_path / "store"),
                      (str(tmp_path / "logs"),), timeout=120)
    for search, log in ((0, "hpo_log.csv"), (1, "hpo_asha_log.csv")):
        rows0, rows1 = res[0][search], res[1][search]
        assert _comparable(rows0) == _comparable(rows1)
        failed = [r for r in rows0 if r["failed"]]
        assert len(failed) == 1 and failed[0]["error"] == "RuntimeError('rank 1 fails')"
        # ASHA: 4 trials at 1 epoch, the best of the 3 that ran at 2
        assert len(rows0) == (4 if search == 0 else 5)
        logged = _asha_rows(tmp_path / "logs" / log)
        assert len(logged) == len(rows0)
        assert [r["failed"] for r in logged] == [str(r["failed"]) for r in rows0]
