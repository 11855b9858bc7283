"""The port's k-fold CV CLI against the JAX package's, on the CPU.

One module-scoped run of each CLI on the same tiny arguments and the same
``dipeptide.npz`` data root: the same mapping per fold, the same artifact
names and CSV headers, configs that load into either package, and test
RMSDs in the same band (within 2x fold by fold; the two packages draw
their initial weights and noise from different streams). Then the port's
readers of a fold: ``postanalysis.reevaluate`` on JAX weights converted
into a port checkpoint (rtol 1e-4 on the RMSDs, det and f32), and
``Backmapper.from_run`` against the in-memory model (exact), plus
``-fold_offset``/``-max_folds``, ``--resume``, the sparse model's folds
(``--sparse``, read back by ``from_run(sparse=True)`` and ``postanalysis``)
and the steric recipe's (``-zeta``, ``--h_project_eval``)."""
import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.cli import postanalysis as jpost
from coarsegrainingvae_tpu.cli import run_cgvae as jcli
from coarsegrainingvae_tpu.config import ExperimentConfig as JaxConfig
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.cli import postanalysis, run_cgvae
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu_torch.models.cgvae import CGequiVAE, build_flagship_model
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.serve import Backmapper
from coarsegrainingvae_tpu_torch.train.checkpoint import CheckpointManager
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

ARGS = ["-n_cgs", "3", "-n_basis", "16", "-n_rbf", "4", "-enc_nconv", "1",
        "-dec_nconv", "1", "-ndata", "48", "-nepochs", "2", "-batch_size", "16",
        "-nsplits", "2", "-beta", "0.01", "-gamma", "1.0", "-n_ensemble", "2",
        "-nevals", "2", "--dec_type", "pseudo", "--graph_eval"]
FOLDS = ["fold0", "fold1"]


class _RecordingTrainer(Trainer):
    """The CLI's Trainer, keeping each fold's instance for the tests."""
    made = []

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made.append(self)


def _run_dir(parent):
    (d,) = [p for p in parent.iterdir() if p.name.startswith("run")]
    return d


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    data = root / "data"
    data.mkdir()
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=48, seed=0, device="cpu")
    save_npz_traj(str(data / "dipeptide.npz"), z, frames, bonds)
    _RecordingTrainer.made = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("COARSEGRAININGVAE_DATA", str(data))
        mp.setattr(run_cgvae, "Trainer", _RecordingTrainer)
        jax_rows = jcli.main(ARGS + ["-logdir", str(root / "jax" / "run")])
        port_rows = run_cgvae.main(ARGS + ["-logdir", str(root / "port" / "run"),
                                           "--device", "cpu"])
    return dict(data=data, jax=_run_dir(root / "jax"), port=_run_dir(root / "port"),
                jax_rows=jax_rows, port_rows=port_rows, trainers=list(_RecordingTrainer.made))


def _artifacts(run):
    """Relative file paths of a run, the checkpoint directories' contents
    left out (orbax in one, torch.save in the other)."""
    out = set()
    for dirpath, dirnames, filenames in os.walk(run):
        rel = os.path.relpath(dirpath, run)
        if "ckpt" in rel.split(os.sep):
            continue
        out.update(os.path.normpath(os.path.join(rel, f)) for f in filenames + dirnames)
    return out


@pytest.mark.parametrize("fold", FOLDS)
def test_mapping_per_fold_is_identical(runs, fold):
    port = json.loads((runs["port"] / fold / "mapping.json").read_text())
    assert port == json.loads((runs["jax"] / fold / "mapping.json").read_text())
    assert sorted(set(port)) == [0, 1, 2]


def test_artifacts_and_csv_headers_are_the_jax_packages(runs):
    """The JAX package's files, and the port's own tracing snapshot in
    each fold."""
    assert runs["port"].name == runs["jax"].name
    own = {f"{fold}/tracing.json" for fold in FOLDS}
    assert _artifacts(runs["port"]) == _artifacts(runs["jax"]) | own
    assert {"cv_stats.csv", "cv_stats_summary.json", "modelparams.json",
            "fold0/ckpt", "fold1/test_samples.xyz"} <= _artifacts(runs["port"])

    def header(path):
        return path.read_text().splitlines()[0]

    assert header(runs["port"] / "cv_stats.csv") == header(runs["jax"] / "cv_stats.csv")
    assert header(runs["port"] / "cv_stats.csv").split(",") == run_cgvae.CV_STAT_FIELDS
    assert run_cgvae.CV_STAT_FIELDS == jcli.CV_STAT_FIELDS
    for fold in FOLDS:
        assert header(runs["port"] / fold / "train_log.csv") == header(
            runs["jax"] / fold / "train_log.csv")
        assert len((runs["port"] / fold / "train_log.csv").read_text().splitlines()) == 3
    summary = json.loads((runs["port"] / "cv_stats_summary.json").read_text())
    assert set(summary) == set(json.loads((runs["jax"] / "cv_stats_summary.json").read_text()))


@pytest.mark.parametrize("fold", FOLDS)
def test_each_fold_writes_its_tracing_snapshot(runs, fold):
    """``tracing.json``: the fold's own set-up spans (its datasets) and the
    phase means of its last train epoch (the CPU program's marks; one
    process, so no exchange phase), with the dense model's decoder and
    loss parts inside the forward phase."""
    snap = json.loads((runs["port"] / fold / "tracing.json").read_text())
    names = [s["name"] for s in snap["spans"]]
    assert names.count("data.build_dataset") >= 1 and "train.capture" not in names
    counters = snap["counters"]
    phases = [f"step.{p}_ms" for p in ("gather", "forward", "backward", "optimizer", "bookkeeping")]
    parts = ["step.decode_ms", "step.loss_ms"]
    assert sorted(k for k in counters if k.endswith("_ms") and k != "step.total_ms") == \
        sorted(phases + parts)
    assert counters["step.steps"] >= 1
    assert sum(counters[k] for k in phases) == pytest.approx(counters["step.total_ms"])
    assert sum(counters[k] for k in parts) < counters["step.forward_ms"]


def test_modelparams_load_into_either_package(runs):
    def fields(cfg):
        d = dataclasses.asdict(cfg)
        d.pop("logdir")
        return d

    paths = [str(runs[k] / "modelparams.json") for k in ("jax", "port")]
    want = fields(JaxConfig.load(paths[0]))
    for path in paths:
        assert fields(JaxConfig.load(path)) == want
        assert fields(tcfg.ExperimentConfig.load(path)) == want


@pytest.mark.parametrize("fold", [0, 1])
def test_recon_rmsd_in_the_jax_band(runs, fold):
    port, ref = runs["port_rows"][fold], runs["jax_rows"][fold]
    assert port["fold"] == ref["fold"] == fold and port["epoch"] == ref["epoch"] == 1
    assert np.isfinite(port["test_all_recon_rmsd"])
    ratio = port["test_all_recon_rmsd"] / ref["test_all_recon_rmsd"]
    assert 0.5 <= ratio <= 2.0, (port["test_all_recon_rmsd"], ref["test_all_recon_rmsd"])


def test_reevaluate_on_converted_jax_weights_matches_jax(runs, tmp_path, monkeypatch):
    """The JAX fold's weights, restored with the JAX checkpoint manager,
    converted and saved as a port checkpoint: both re-evaluations give the
    same test RMSDs at rtol 1e-4 (det, f32)."""
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    raw = json.loads((runs["jax"] / "modelparams.json").read_text())
    raw["model"].update(det=True, compute_dtype="float32")
    params_path = tmp_path / "modelparams.json"
    params_path.write_text(json.dumps(raw))
    jax_fold = runs["jax"] / "fold0"
    _, _, jstate, _, jds = jpost.load_run(str(params_path), str(jax_fold))

    cfg = tcfg.ExperimentConfig.load(str(params_path))
    model = DenseCGVAE(cfg.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), cfg.model))
    ds = CGDatasetArrays(**{f.name: getattr(jds, f.name)
                            for f in dataclasses.fields(CGDatasetArrays)})
    state = Trainer(model, cfg, device="cpu").init_state(ds.batch(np.arange(16)))
    fold = tmp_path / "fold0"
    fold.mkdir()
    shutil.copy(jax_fold / "mapping.json", fold / "mapping.json")
    CheckpointManager(str(fold / "ckpt")).save(0, state)

    got = postanalysis.reevaluate(str(params_path), str(fold), n_ensemble=2, nevals=2,
                                  device="cpu")
    want = jpost.reevaluate(str(params_path), str(jax_fold), n_ensemble=2, nevals=2)
    for key in ("all_atom_rmsd", "heavy_atom_rmsd"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4)
    assert set(got) == set(want)
    assert np.asarray(got["tica_gen"]).shape == np.asarray(want["tica_gen"]).shape


def test_from_run_equals_the_in_memory_backmapper(runs, monkeypatch):
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    run = runs["port"]
    bm = Backmapper.from_run(str(run / "modelparams.json"), str(run / "fold0"), device="cpu")
    trained = runs["trainers"][0].model
    cfg = tcfg.ExperimentConfig.load(str(run / "modelparams.json"))
    mapping = json.loads((run / "fold0" / "mapping.json").read_text())
    ref = Backmapper(trained, mapping, bm.z, cfg, device="cpu")
    for name, p in trained.named_parameters():
        torch.testing.assert_close(dict(bm.model.named_parameters())[name], p, rtol=0, atol=0)
    cg = np.random.default_rng(0).normal(size=(2, 3, 3)).astype(np.float32) * 3.0
    np.testing.assert_array_equal(bm.backmap(cg, n_samples=3, seed=4),
                                  ref.backmap(cg, n_samples=3, seed=4))


def test_postanalysis_main_reads_a_port_fold(runs, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    run = runs["port"]
    res = postanalysis.main(["-modelparams", str(run / "modelparams.json"),
                             "-logdir", str(run / "fold1"), "-out", str(tmp_path / "o.json"),
                             "--device", "cpu"])
    printed = json.loads(capsys.readouterr().out)
    assert set(printed) == {"all_atom_rmsd", "heavy_atom_rmsd", "all_valid_ratio",
                            "heavy_valid_ratio", "all_ged", "heavy_ged"}
    assert np.isfinite(res["all_atom_rmsd"]) and len(res["tica_gen"]) == 16 * 8   # nevals x n_ensemble
    assert json.loads((tmp_path / "o.json").read_text())["tica_true"] == res["tica_true"]


def test_fold_offset_runs_only_that_fold(runs, tmp_path, monkeypatch):
    """As the JAX ``test_run_cgvae_cli_fold_offset``: fold 1 alone, and it is
    fold 1 of the full run."""
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    rows = run_cgvae.main(ARGS + ["-logdir", str(tmp_path / "run"), "-fold_offset", "1",
                                  "-max_folds", "1", "--device", "cpu"])
    assert len(rows) == 1 and rows[0]["fold"] == 1
    run = _run_dir(tmp_path)
    assert (run / "fold1" / "train_log.csv").exists()
    assert not (run / "fold0").exists()
    assert (run / "fold1" / "mapping.json").read_text() == (
        runs["port"] / "fold1" / "mapping.json").read_text()
    assert not (run / "cv_stats_summary.json").exists()      # one fold: no rollup


def test_resume_continues_a_fold(runs, tmp_path, monkeypatch):
    """run_cv --resume on a copy of the run: fold 0 restarts at epoch 2 and
    appends to its train_log.csv and the run's cv_stats.csv."""
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    run = tmp_path / runs["port"].name
    shutil.copytree(runs["port"], run)
    cfg = tcfg.ExperimentConfig.load(str(run / "modelparams.json"))
    cfg = dataclasses.replace(cfg, logdir=str(run),
                              train=dataclasses.replace(cfg.train, nepochs=3))
    rows = run_cgvae.run_cv(cfg, n_ensemble=2, nevals=2, resume=True, max_folds=1,
                            device="cpu")
    assert len(rows) == 1 and rows[0]["epoch"] == 2
    log = (run / "fold0" / "train_log.csv").read_text().splitlines()
    assert [line.split(",")[0] for line in log[1:]] == ["0", "1", "2"]
    assert len((run / "cv_stats.csv").read_text().splitlines()) == 1 + 3
    assert CheckpointManager(str(run / "fold0" / "ckpt")).all_steps() == [1, 2]


@pytest.mark.parametrize("dec_type,sparse,force", [
    ("pseudo2", False, False), ("en", False, False), ("inv", False, False),
    ("pseudo", True, False), ("pseudo", False, True)])
def test_sparse_models_build_cgequivae(dec_type, sparse, force):
    """build_flagship_model picks the sparse CGequiVAE where the JAX
    package's does: --sparse, cfg.sparse and the pseudo2/en/inv decoders."""
    cfg = tcfg.ModelConfig(n_basis=8, dec_type=dec_type, sparse=sparse)
    model = build_flagship_model(cfg, force_sparse=force)
    assert isinstance(model, CGequiVAE) and model.cfg.dec_type == dec_type
    assert isinstance(build_flagship_model(tcfg.ModelConfig(n_basis=8)), DenseCGVAE)


@pytest.mark.parametrize("extra", [
    ["--sparse"], ["-zeta", "1.0", "-zeta_warmup", "2", "--steric_data_margin",
                   "--h_project_eval"]])
def test_sparse_and_steric_folds_run(runs, tmp_path, monkeypatch, extra):
    """One fold of the sparse model, and one of the steric recipe (tables
    from the fold's frames, the ramp, the eval projection), on the CPU;
    the fold reads back through from_run and postanalysis as the model it
    trained."""
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    made = []

    class Recording(Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)

    monkeypatch.setattr(run_cgvae, "Trainer", Recording)
    rows = run_cgvae.main(ARGS + ["-logdir", str(tmp_path / "run"), "-max_folds", "1",
                                  "--device", "cpu"] + extra)
    # sample RMSDs average over valid samples only: NaN when none is valid
    assert len(rows) == 1 and all(np.isfinite(v) for k, v in rows[0].items()
                                  if k not in ("sample_all_rmsd", "sample_heavy_rmsd"))
    run = _run_dir(tmp_path)
    assert _artifacts(run) >= {"fold0/train_log.csv", "fold0/test_samples.xyz", "cv_stats.csv"}
    (tr,) = made
    cfg = tcfg.ExperimentConfig.load(str(run / "modelparams.json"))
    sparse = "--sparse" in extra
    assert isinstance(tr.model, CGequiVAE) == sparse == cfg.model.sparse
    assert (tr.steric_tables is not None) == (cfg.train.zeta > 0) == (not sparse)
    bm = Backmapper.from_run(str(run / "modelparams.json"), str(run / "fold0"), sparse=sparse,
                             device="cpu")
    assert type(bm.model) is type(tr.model)
    mapping = json.loads((run / "fold0" / "mapping.json").read_text())
    ref = Backmapper(tr.model, mapping, bm.z, cfg, device="cpu", bonds=bm.bonds,
                     ref_xyz=bm.ref_xyz)
    cg = np.random.default_rng(0).normal(size=(2, 3, 3)).astype(np.float32) * 3.0
    np.testing.assert_array_equal(bm.backmap(cg, n_samples=3, seed=4),
                                  ref.backmap(cg, n_samples=3, seed=4))
    res = postanalysis.reevaluate(str(run / "modelparams.json"), str(run / "fold0"),
                                  n_ensemble=2, nevals=2, device="cpu")
    assert np.isfinite(res["all_atom_rmsd"])


def test_cli_runs_on_the_card_by_default():
    args = run_cgvae.build_parser().parse_args([])
    assert args.device == "cuda"
    ref = jcli.build_parser().parse_args([])
    assert {k: v for k, v in vars(args).items() if k != "device"} == vars(ref)


def _cv_rows(run):
    import csv

    with open(run / "cv_stats.csv") as f:
        return list(csv.DictReader(f))


def test_torchrun_two_ranks_match_one_process(runs, tmp_path, monkeypatch):
    """run_cgvae under ``torch.distributed.run --nproc_per_node 2`` on the
    CPU (gloo): one fold of one epoch, data-parallel. Rank 0 alone writes:
    the run holds the one-process run's files and one row per fold and
    epoch. Its cv_stats.csv row equals the one-process run's within 1e-3
    (the default bf16 matmuls round each rank's half batch on its own;
    the KL column, a bf16 sum, within 1e-2)."""
    import subprocess
    import sys

    args = ARGS + ["-max_folds", "1", "-nepochs", "1", "--device", "cpu"]
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(runs["data"]))
    run_cgvae.main(args + ["-logdir", str(tmp_path / "one" / "run")])
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "2",
         "-m", "coarsegrainingvae_tpu_torch.cli.run_cgvae", *args,
         "-logdir", str(tmp_path / "two" / "run")],
        cwd=root, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    one, two = _run_dir(tmp_path / "one"), _run_dir(tmp_path / "two")
    assert _artifacts(two) == _artifacts(one)
    with open(two / "fold0" / "train_log.csv") as f:
        assert len(f.read().strip().splitlines()) == 2          # header and epoch 0
    (got,), (want,) = _cv_rows(two), _cv_rows(one)
    for k, v in want.items():
        if k in ("fold", "epoch"):
            assert got[k] == v
        elif k != "wall_s":
            np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-2 if k == "KL" else 1e-3,
                                       err_msg=k)
