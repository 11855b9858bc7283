"""The analysis, plotting, VMD, profiling and geometry helpers of the port
against the JAX package on the same numpy inputs (CPU), and the port's
analysis demo on a tiny fold."""
import importlib.util
import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.data import batch as jbatch
from coarsegrainingvae_tpu.eval import analysis as janalysis
from coarsegrainingvae_tpu.ops import geometry as jgeom
from coarsegrainingvae_tpu.utils import profiling as jprofiling
from coarsegrainingvae_tpu.utils import vmd as jvmd
from coarsegrainingvae_tpu_torch.data import batch as tbatch
from coarsegrainingvae_tpu_torch.eval import analysis
from coarsegrainingvae_tpu_torch.ops import geometry
from coarsegrainingvae_tpu_torch.utils import profiling, visualization, vmd

torch.set_num_threads(1)

PNG = b"\x89PNG\r\n\x1a\n"


def _backbone(n_res=5, seed=0):
    """Per-atom names and residue index of a chain, a backbone atom of
    residue 2 missing, and frames of it."""
    rng = np.random.default_rng(seed)
    names, res = [], []
    for r in range(n_res):
        for nm in ("N", "CA", "C", "O", "CB"):
            if not (r == 2 and nm == "C"):
                names.append(nm)
                res.append(r)
    xyz = rng.normal(size=(6, len(names), 3)).astype(np.float32) * 2.0
    return names, np.asarray(res), xyz


def test_phi_psi_quads_match_jax():
    names, res, _ = _backbone()
    got, want = analysis.phi_psi_quads(names, res), janalysis.phi_psi_quads(names, res)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert len(got[0]) and len(got[1])


def test_ramachandran_matches_jax():
    names, res, xyz = _backbone()
    phi_q, psi_q = janalysis.phi_psi_quads(names, res)
    got = analysis.ramachandran(xyz, phi_q, psi_q, device="cpu")
    want = janalysis.ramachandran(xyz, phi_q, psi_q)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (6, len(g[0]))
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_kde_free_energy_matches_jax_exactly():
    rng = np.random.default_rng(1)
    x, y = rng.normal(size=200), rng.normal(size=200) * 0.5
    for g, w in zip(analysis.kde_free_energy(x, y, grid=30), janalysis.kde_free_energy(x, y, 30)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kw", [{}, dict(style="licorice", background="black"),
                                dict(style="vdw", material="Glossy", orthographic=False)])
def test_vmd_script_is_the_same_text(tmp_path, kw):
    got = vmd.write_vmd_render_script(str(tmp_path / "port.vmd"), **kw)
    want = jvmd.write_vmd_render_script(str(tmp_path / "jax.vmd"), **kw)
    assert Path(got).read_bytes() == Path(want).read_bytes()
    with pytest.raises(KeyError):
        vmd.write_vmd_render_script(str(tmp_path / "x.vmd"), style="ribbons")


@pytest.mark.parametrize("n_edges,budget", [(0, 4), (3, 5), (5, 5)])
def test_pad_edges_matches_jax(n_edges, budget):
    edges = np.arange(2 * n_edges, dtype=np.int32).reshape(n_edges, 2)
    for g, w in zip(tbatch.pad_edges(edges, budget), jbatch.pad_edges(edges, budget)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        tbatch.pad_edges(edges, n_edges - 1)


def test_rotation_helpers_match_jax():
    rng = np.random.default_rng(2)
    vec = rng.normal(size=(7, 3)).astype(np.float32)
    axis = vec / np.linalg.norm(vec, axis=-1, keepdims=True)
    angle = rng.uniform(-np.pi, np.pi, size=7).astype(np.float32)
    rot = geometry.rotation_matrix_from_axis_angle(torch.as_tensor(axis), torch.as_tensor(angle))
    jrot = jgeom.rotation_matrix_from_axis_angle(jnp.asarray(axis), jnp.asarray(angle))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), rtol=1e-4, atol=1e-5)
    xyz = rng.normal(size=(7, 5, 3)).astype(np.float32)
    np.testing.assert_allclose(geometry.rotate(torch.as_tensor(xyz), rot).numpy(),
                               np.asarray(jgeom.rotate(jnp.asarray(xyz), jrot)),
                               rtol=1e-4, atol=1e-5)
    y = xyz + rng.normal(size=xyz.shape).astype(np.float32) * 0.3
    mask = rng.random((7, 5)) > 0.3
    for m in (None, mask):
        got = geometry.unaligned_rmsd(torch.as_tensor(xyz), torch.as_tensor(y),
                                      None if m is None else torch.as_tensor(m))
        want = jgeom.unaligned_rmsd(jnp.asarray(xyz), jnp.asarray(y),
                                    None if m is None else jnp.asarray(m))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-5)


def test_random_rotations_are_proper():
    rot = geometry.random_rotation_matrices(torch.Generator().manual_seed(0), 64)
    eye = torch.eye(3).expand(64, 3, 3)
    assert torch.allclose(rot @ rot.transpose(-1, -2), eye, atol=1e-5)
    assert torch.allclose(torch.linalg.det(rot), torch.ones(64), atol=1e-5)
    again = geometry.random_rotation_matrices(torch.Generator().manual_seed(0), 64)
    assert torch.equal(rot, again)


def test_plots_write_pngs(tmp_path):
    rng = np.random.default_rng(3)
    analysis.plot_free_energy(rng.normal(size=100), rng.normal(size=100),
                              str(tmp_path / "fe.png"), grid=20)
    assign = rng.dirichlet(np.ones(3), size=10)
    visualization.plot_assignment(assign, np.array([6, 1, 1, 8, 7, 6, 6, 1, 8, 16]),
                                  str(tmp_path / "assign.png"))
    visualization.plot_assignment(assign, None, str(tmp_path / "assign_plain.png"))
    for name in ("fe.png", "assign.png", "assign_plain.png"):
        assert (tmp_path / name).read_bytes()[:8] == PNG


def test_step_timer_and_compile_timing_on_the_cpu(tmp_path):
    timer = profiling.StepTimer(warmup=1)
    timer.start()
    for _ in range(4):
        torch.ones(8).sum()
        timer.tick()
    s = timer.summary(items_per_step=8)
    assert s["steps"] == 3 and s["mean_s"] > 0 and s["items_per_s"] > 0
    jtimer = jprofiling.StepTimer(warmup=1)
    jtimer._t = list(timer._t)
    assert jtimer.summary(items_per_step=8) == s          # the same statistics
    assert profiling.StepTimer().summary() == {}
    calls = []
    out = profiling.time_compile(lambda x: calls.append(x), 1)
    assert calls == [1, 1] and out["first_call_s"] >= 0 and out["compile_s_approx"] >= 0
    assert set(out) == {"first_call_s", "steady_s", "compile_s_approx"}
    profiling.save_runtime(1.5, str(tmp_path / "rt.json"))
    jprofiling.save_runtime(1.5, str(tmp_path / "jrt.json"))
    assert (tmp_path / "rt.json").read_bytes() == (tmp_path / "jrt.json").read_bytes()


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "tb")) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    trace = json.loads((tmp_path / "tb" / "trace.json").read_text())
    assert trace["traceEvents"] and prof.key_averages()


# --------------------------------------------------------------- the demo
def test_analysis_demo_runs_on_a_port_fold(tmp_path, monkeypatch):
    from coarsegrainingvae_tpu_torch.cli import run_cgvae
    from coarsegrainingvae_tpu_torch.data.proteins import save_npz_traj
    from coarsegrainingvae_tpu_torch.data.synthetic import synthetic_peptide

    z, frames, bonds = synthetic_peptide("dipeptide", n_frames=40, seed=0, device="cpu")
    save_npz_traj(str(tmp_path / "dipeptide.npz"), z, frames, bonds)
    monkeypatch.setenv("COARSEGRAININGVAE_DATA", str(tmp_path))
    run_cgvae.main(["-logdir", str(tmp_path / "run"), "-n_basis", "16", "-n_rbf", "4",
                    "-enc_nconv", "1", "-dec_nconv", "1", "-ndata", "40", "-batch_size", "8",
                    "-nsplits", "2", "-max_folds", "1", "-nepochs", "1", "-n_ensemble", "2",
                    "-nevals", "2", "--dec_type", "pseudo", "--device", "cpu"])
    (run,) = tmp_path.glob("run_*")
    spec = importlib.util.spec_from_file_location(
        "analysis_demo_torch",
        Path(__file__).resolve().parents[1] / "examples" / "analysis_demo_torch.py")
    demo = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(demo)
    out = tmp_path / "out"
    summary = demo.main(["-modelparams", str(run / "modelparams.json"), "-logdir",
                         str(run / "fold0"), "-out", str(out), "-nevals", "6",
                         "-n_ensemble", "4", "--device", "cpu"])
    assert summary["quads_from"] == "heavy-atom path" and summary["n_generated"] == 24
    for name in ("free_energy_true", "free_energy_generated", "ramachandran_true",
                 "ramachandran_generated"):
        assert (out / f"{name}.png").read_bytes()[:8] == PNG
    angles = np.load(out / "projections.npz")
    assert np.isfinite(angles["phi_gen"]).all() and angles["phi_gen"].shape == (24,)
    # the stand-in quads are the JAX package's dihedrals of the same atoms
    phi_q = np.asarray([summary["phi_quad"]], np.int32)
    got, _ = analysis.ramachandran(frames[:3], phi_q, phi_q, device="cpu")
    want, _ = janalysis.ramachandran(frames[:3], phi_q, phi_q)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
