"""The JAX package's example tools against their ports
(``examples/*_torch.py``), on the CPU.

Each original runs with its costly parts replaced where a test needs only
what it builds or prints: its timing loops record their labels (and the
shape table's step functions and arrays), its ``Trainer`` records the
config it is given. The ports run as they are, on the CPU and narrow: the
shape table's plain path against the original's jitted ``*_reference``
step, the ablation's sections and ``forward_loss``, the A/B harness's data,
configs and one f32 step from JAX's initial parameters (``det=True``), the
quickstart end to end, and the census on one reconstruction.
"""
import dataclasses
import importlib.util
import json
import sys
import tempfile
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu import config as jcfg
from coarsegrainingvae_tpu.models.dense_cgvae import DenseCGVAE as JaxModel
from coarsegrainingvae_tpu.parallel.mesh import make_mesh
from coarsegrainingvae_tpu.train.trainer import Trainer as JaxTrainer
from coarsegrainingvae_tpu_torch import config as tcfg
from coarsegrainingvae_tpu_torch.convert import convert_flax_params
from coarsegrainingvae_tpu_torch.data.dataset import CGDatasetArrays
from coarsegrainingvae_tpu_torch.models.dense_cgvae import DenseCGVAE
from coarsegrainingvae_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
# f32, the same arithmetic in another order (tests/test_torch_convert_run.py)
F32_TOL = dict(rtol=1e-4, atol=1e-5)
# relaxed frames: XLA and torch order the force sums differently
# (tests/test_torch_data.py::RELAX_ATOL)
RELAX_ATOL = 1e-3
AB_VARIANTS = "float32,bfloat16,bfloat16+bf16adam,bfloat16+bf16adam+b64"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _labels(text: str) -> list:
    return [json.loads(line)["label"] for line in text.splitlines()
            if line.startswith("{") and "label" in json.loads(line)]


@pytest.fixture
def no_xla_cache(monkeypatch):
    """The originals' ``enable_cache`` would move this process's XLA cache."""
    from coarsegrainingvae_tpu.utils import compile_cache

    monkeypatch.setattr(compile_cache, "enable", lambda *a, **k: None)


def _port_dataset(jds) -> CGDatasetArrays:
    return CGDatasetArrays(**{f.name: getattr(jds, f.name)
                              for f in dataclasses.fields(CGDatasetArrays)})


# ------------------------------------------------------------ shape table
@pytest.fixture(scope="module")
def kernels():
    return _load("profile_kernels"), _load("profile_kernels_torch")


def _original_steps(jk, monkeypatch, kind, b, n, f):
    """{label: (step, args)} of one shape of the original, recorded by its
    ``timed``."""
    seen = {}
    monkeypatch.setattr(jk, "timed", lambda fn, args, steps, label: seen.update(
        {label: (fn, args)}))
    bench = jk.bench_pseudo if kind == "pseudo" else jk.bench_message
    bench(b, n, f, 8, jk_cutoff(kind), 1, True)
    return seen


def jk_cutoff(kind):
    return 21.0 if kind == "pseudo" else 9.5


@pytest.mark.parametrize("kind,b,n", [("pseudo", 2, 3), ("pseudo", 2, 7), ("message", 2, 9)])
def test_shape_table_row_matches_the_original(kernels, monkeypatch, kind, b, n):
    """The port's arrays are the original's bit for bit; the step scalar of
    the port's plain path (and of the kernel wrapper, which takes it on the
    CPU) equals the original's jitted ``*_reference`` step."""
    jk, pk = kernels
    f = 32
    size = "M" if kind == "pseudo" else "N"
    fn, args = _original_steps(jk, monkeypatch, kind, b, n, f)[f"{kind}_xla_B{b}_{size}{n}_F{f}"]
    arrays = pk.pseudo_inputs(b, n, f) if kind == "pseudo" else pk.message_inputs(b, n, f)
    names = [k for k in pk.ORDER[kind] if k != "mask"]
    assert len(args) == len(names) + 1
    for name, a in zip(names, args[1:]):
        np.testing.assert_array_equal(np.asarray(a), arrays[name], err_msg=name)
    want = float(jax.jit(fn)(*args[1:]))
    t = pk.to_tensors(arrays, "cpu")
    for path, step in pk.paths(kind).items():
        got = float(pk.step(kind, step, t, pk.CUTOFF[kind])[0])
        np.testing.assert_allclose(got, want, **F32_TOL, err_msg=path)


def test_shape_table_labels_match_the_original(kernels, monkeypatch, capsys, no_xla_cache):
    """Every row the original prints (the VMEM-skipped ones too) has the
    port's row of the same label, in the same order; every port row runs."""
    jk, pk = kernels
    monkeypatch.setattr(jk, "timed", lambda fn, args, steps, label: print(
        json.dumps({"label": label})))
    monkeypatch.setattr(sys, "argv", ["profile_kernels.py", "--f", "4"])
    jk.main()
    want = _labels(capsys.readouterr().out)
    rows = pk.main(["--f", "4", "--steps", "1", "--device", "cpu"])
    assert [r["label"] for r in rows] == want and len(want) == 14
    kernel_rows = rows[1::2]
    assert all(r["max_rel_err"] == 0.0 and r["ms_per_step"] > 0 for r in kernel_rows)


# --------------------------------------------------------------- ablation
# widths at which every bead of the config's mapping fits the channel lift
ABLATION_WIDTH = {"dipeptide": 16, "chignolin": 64}


@pytest.mark.parametrize("config", ["dipeptide", "chignolin"])
def test_ablation_sections_match_the_original(monkeypatch, capsys, no_xla_cache, config):
    """The layers and modules sections' labels and counts (and the shape
    row's B, N, M), the original run narrow with its timing loop and the
    initialisation of its Trainer and modules left out."""
    jf = _load("profile_flagship")
    pf = _load("profile_flagship_torch")
    width = ABLATION_WIDTH[config]
    real_cfg = jcfg.ModelConfig

    class FakeTrainer:
        def __init__(self, model, cfg, mesh=None):
            self.model, self.cfg = model, cfg

        def init_state(self, batch, seed=0):
            return SimpleNamespace(params={})

    import coarsegrainingvae_tpu.data.synthetic as jsynthetic
    import coarsegrainingvae_tpu_torch.data.synthetic as tsynthetic

    # the port reads the original's frames: the labels do not depend on
    # them, and relaxing chignolin's 209 atoms on one CPU thread is slow
    frames = {}
    real_peptide = jsynthetic.synthetic_peptide
    monkeypatch.setattr(jsynthetic, "synthetic_peptide", lambda *a, **k: frames.setdefault(
        "jax", real_peptide(*a, **k)))
    monkeypatch.setattr(tsynthetic, "synthetic_peptide", lambda *a, **k: frames["jax"])
    monkeypatch.setattr(jcfg, "ModelConfig", lambda **kw: real_cfg(**{**kw, "n_basis": width}))
    monkeypatch.setattr("coarsegrainingvae_tpu.train.trainer.Trainer", FakeTrainer)
    # the modules' parameters feed only the timing loop
    monkeypatch.setattr("flax.linen.Module.init", lambda self, *a, **k: {})
    monkeypatch.setattr(jf, "timed_scan", lambda fn, carry, n, label, *a, **k: (
        print(json.dumps({"label": label})), 1e-3)[1])
    monkeypatch.setattr(sys, "argv", ["profile_flagship.py", "--config", config,
                                      "--only", "layers,modules"])
    jf.main()
    out = capsys.readouterr().out
    shape = json.loads(out.splitlines()[0])
    want = _labels(out)
    rows = pf.main(["--config", config, "--only", "layers,modules", "--steps", "1",
                    "--device", "cpu"], n_basis=width)
    assert [r["label"] for r in rows] == want
    assert {k: rows[0][k] for k in ("B", "N", "M", "F")} == {k: shape[k] for k in "BNMF"}
    assert [r["label"] for r in rows if r["label"].endswith(")")] == [
        f"{label} (x{count})" for label, count in pf.MODULES]


def test_ablation_forward_loss_is_the_trainers_loss():
    """``forward_loss`` at a tiny width equals the loss the trainer's step
    reports on the same batch and the same draws."""
    pf = _load("profile_flagship_torch")
    cfg, ds, batch, tr, state = pf.setup("dipeptide", 8, "float32", "float32", "cpu", 16)
    got = pf.forward_loss(tr, batch, torch.Generator().manual_seed(5))
    _, metrics = tr.train_step(state, batch, torch.Generator().manual_seed(5))
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got.detach()), float(metrics["loss"]), rtol=1e-6)


# --------------------------------------------------------------------- A/B
@pytest.fixture(scope="module")
def ab_original():
    """What the original's main builds: its frames, mapping and dataset, and
    the ExperimentConfig of each variant (its Trainer records them; its
    training and reconstruction are left out)."""
    import coarsegrainingvae_tpu.data.dataset as jdataset
    import coarsegrainingvae_tpu.eval.sampling as jsampling
    import coarsegrainingvae_tpu.train.trainer as jtrainer
    from coarsegrainingvae_tpu.utils import compile_cache

    ja = _load("accuracy_ab")
    seen = {"cfgs": []}
    real_build = jdataset.build_dataset

    def build(mapping, frames, **kw):
        seen.update(mapping=mapping, frames=frames, ds=real_build(mapping, frames, **kw))
        return seen["ds"]

    class FakeTrainer:
        def __init__(self, model, cfg, mesh=None):
            seen["cfgs"].append(cfg)

        def init_state(self, batch, seed=0):
            return None

        def fit(self, state, train, val, nepochs=None):
            return SimpleNamespace(params=None), [{"val_recon": 0.0, "val_loss": 0.0}]

    def reconstruct_all(trainer, params, ds, rng, graph_eval=True):
        xyz = np.zeros((len(ds), ds.xyz.shape[1], 3), np.float32)
        return {"recon_xyzs": xyz, "true_xyzs": xyz}

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(compile_cache, "enable", lambda *a, **k: None)
        mp.setattr(jdataset, "build_dataset", build)
        mp.setattr(jtrainer, "Trainer", FakeTrainer)
        mp.setattr(jsampling, "reconstruct_all", reconstruct_all)
        mp.setattr(sys, "argv", ["accuracy_ab.py", "--variants", AB_VARIANTS, "--epochs", "1"])
        ja.main()
    seen["module"] = ja
    return seen


@pytest.fixture(scope="module")
def ab_port():
    return _load("accuracy_ab_torch")


def test_ab_data_and_split_match_the_original(ab_original, ab_port):
    data = ab_port.ab_data("cpu")
    np.testing.assert_array_equal(data.mapping, ab_original["mapping"])
    np.testing.assert_allclose(data.frames, ab_original["frames"], rtol=0, atol=RELAX_ATOL)
    jds = ab_original["ds"]
    np.testing.assert_array_equal(data.ds.z, jds.z)
    np.testing.assert_array_equal(data.ds.bonds, jds.bonds)
    for got, (lo, hi) in zip((data.train, data.val, data.test), ((0, 810), (810, 900),
                                                                  (900, 1100))):
        want = jds.subset(np.arange(lo, hi))
        assert len(got) == hi - lo
        np.testing.assert_allclose(got.xyz, want.xyz, rtol=0, atol=RELAX_ATOL)
        np.testing.assert_allclose(got.cg_xyz, want.cg_xyz, rtol=0, atol=RELAX_ATOL)


def test_ab_variant_configs_match_the_original(ab_original, ab_port):
    variants = AB_VARIANTS.split(",")
    assert len(ab_original["cfgs"]) == len(variants)
    for variant, jc in zip(variants, ab_original["cfgs"]):
        assert dataclasses.asdict(ab_port.variant_config(variant)) == dataclasses.asdict(
            tcfg.ExperimentConfig.from_json(jc.to_json())), variant


def test_ab_unknown_token_raises_as_in_the_original(ab_original, ab_port, monkeypatch,
                                                    no_xla_cache):
    import coarsegrainingvae_tpu.data.dataset as jdataset
    import coarsegrainingvae_tpu.data.synthetic as jsynthetic

    jds = ab_original["ds"]
    monkeypatch.setattr(jsynthetic, "synthetic_peptide", lambda *a, **k: (
        jds.z, ab_original["frames"], jds.bonds))
    monkeypatch.setattr(jdataset, "build_dataset", lambda *a, **k: jds)
    monkeypatch.setattr(sys, "argv", ["accuracy_ab.py", "--variants", "float32+b6x"])
    with pytest.raises(ValueError, match="unknown variant token 'b6x'"):
        ab_original["module"].main()
    with pytest.raises(ValueError, match="unknown variant token 'b6x'"):
        ab_port.main(["--variants", "float32,float32+b6x", "--device", "cpu"])
    assert ab_port.parse_variant("bfloat16+bf16adam+b64") == ("bfloat16", "bfloat16", 64)


def test_ab_f32_step_from_jax_init_matches_jax(ab_original, ab_port):
    """One step of the float32 variant's trainer (n_basis 16, ``det=True``)
    from JAX's initial parameters (seed 123) through ``convert.py``, on the
    first train batch: the loss and metrics at F32_TOL, the parameters after
    the step at 1e-4 of each tensor's largest entry plus 2e-5 (as
    tests/test_torch_convert_run.py's step)."""
    jds = ab_original["ds"].subset(np.arange(0, 810))
    tc = ab_port.variant_config("float32", n_basis=16)
    tc = dataclasses.replace(tc, model=dataclasses.replace(tc.model, det=True))
    jc = jcfg.ExperimentConfig.from_json(tc.to_json())
    batch = jds.batch(np.arange(32))
    jtr = JaxTrainer(JaxModel(cfg=jc.model), jc, mesh=make_mesh(1))
    jstate = jtr.init_state(batch, seed=123)
    model = DenseCGVAE(tc.model)
    model.load_state_dict(convert_flax_params(jax.device_get(jstate.params), tc.model))
    tr = Trainer(model, tc, device="cpu")
    tbatch = _port_dataset(jds).batch(np.arange(32))
    state = tr.init_state(tbatch)
    jstate, jm = jtr.train_step(jstate, batch, jax.random.PRNGKey(0))
    state, tm = tr.train_step(state, tbatch)
    for k in ("loss", "recon", "kl", "graph"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **F32_TOL, err_msg=k)
    want = convert_flax_params(jax.device_get(jstate.params), tc.model)
    for name, p in state.params.items():
        ref = want[name].numpy()
        np.testing.assert_allclose(p.detach().numpy(), ref, rtol=0,
                                   atol=2e-5 + 1e-4 * np.abs(ref).max(), err_msg=name)


# -------------------------------------------------------------- quickstart
def test_quickstart_runs_and_prepares_the_originals_data(tmp_path, monkeypatch, no_xla_cache):
    """The original's frames, mapping and datasets (each package
    synthesising its own frames), then the port's quickstart end to end."""
    jq = _load("quickstart")
    pq = _load("quickstart_torch")
    monkeypatch.delenv("COARSEGRAININGVAE_DATA", raising=False)
    seen = []

    class Stop(Exception):
        pass

    def build(*a, **k):
        seen.append(real_build(*a, **k))
        return seen[-1]

    def stop(*a, **k):
        raise Stop

    real_build = jq.build_dataset
    monkeypatch.setattr(jq, "build_dataset", build)
    monkeypatch.setattr(jq, "Trainer", stop)
    monkeypatch.setattr(jq, "enable_cache", lambda: None)
    (tmp_path / "jax").mkdir()
    (tmp_path / "torch").mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "jax"))
    with pytest.raises(Stop):
        jq.main(out_dir=str(tmp_path / "jq"), ndata=200, nepochs=1)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path / "torch"))
    data = pq.prepare(200, "cpu")
    assert (tmp_path / "torch" / "cgvae_synth_cache").is_dir()
    for got, want in zip((data.train, data.val, data.test), seen):
        assert len(got) == len(want)
        for f in dataclasses.fields(CGDatasetArrays):
            g, w = getattr(got, f.name), getattr(want, f.name)
            if f.name in ("xyz", "cg_xyz"):
                np.testing.assert_allclose(g, w, rtol=0, atol=RELAX_ATOL, err_msg=f.name)
            elif g is None or np.isscalar(g):
                assert g == w, f.name
            else:
                np.testing.assert_array_equal(g, w, err_msg=f.name)

    out = pq.main(out_dir=str(tmp_path / "out"), ndata=200, nepochs=1, device="cpu")
    # the original returns backmap's (n_samples, N, 3) for one CG frame
    assert out["ensemble"] == (8, 27, 3) and np.isfinite(out["rmsd"])
    assert (tmp_path / "out" / "ensemble.xyz").stat().st_size > 0


# ------------------------------------------------------------------ census
def test_census_and_margins_equal_the_originals(tmp_path):
    from coarsegrainingvae_tpu.utils.xyz import read_xyz as jread_xyz
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide
    from coarsegrainingvae_tpu_torch.utils.xyz import read_xyz, write_xyz

    jc = _load("validity_census")
    pc = _load("validity_census_torch")
    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=16, seed=3, device="cpu")
    rng = np.random.default_rng(0)
    path = str(tmp_path / "test_recon.xyz")
    write_xyz(path, frames + rng.normal(scale=0.35, size=frames.shape), z)
    (tz, recon), (jz, jrecon) = read_xyz(path), jread_xyz(path)
    np.testing.assert_array_equal(recon, jrecon)
    np.testing.assert_array_equal(tz, jz)
    got, want = pc.census(recon, z, bonds, top=6), jc.census(jrecon, z, bonds, top=6)
    assert got == want
    assert want["missing_covalent"] and want["spurious_contacts"] and want["frames"] == 16
    pairs = want["heavy_spurious_contacts"] or want["spurious_contacts"]
    assert pc.data_margins(frames, z, bonds, pairs) == jc.data_margins(frames, z, bonds, pairs)
