"""The port's host C++ (the cell-list radius graph and the bond-graph diff)
against the JAX package's and against the port's own dense paths.

The port builds its copies of the sources with g++ into ``build/native/``.
The JAX package builds its own next to its sources, with no lock across
processes, where other test workers may be building at the same moment;
here its wrappers load libraries built from its sources into a private
directory instead (the ``jax_native`` fixture). Same flags, so the same
distance comparisons: the cell list's arrays are equal bit for bit.
The dense numpy path orders each receiver's partners differently, so it is
compared per receiver as a set, with an equal mask.
"""
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from coarsegrainingvae_tpu.data.synthetic import synthetic_peptide
from coarsegrainingvae_tpu.eval import metrics as jmetrics
from coarsegrainingvae_tpu.native import bond_diff as jbond_diff
from coarsegrainingvae_tpu.native import cell_list as jcell_list
from coarsegrainingvae_tpu_torch.data import neighbors
from coarsegrainingvae_tpu_torch.eval import metrics
from coarsegrainingvae_tpu_torch.native import bond_diff, cell_list

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
METRIC_KEYS = ("valid_ratio", "valid_allatom_ratio", "graph_val_ratio",
               "graph_allatom_val_ratio", "graph_edit_ratio", "graph_allatom_edit_ratio")


@pytest.fixture(scope="module")
def jax_native(tmp_path_factory):
    """The JAX package's ``native`` wrappers on libraries built from its
    own sources with its own g++ flags, into a private directory."""
    from coarsegrainingvae_tpu.native import build as jbuild

    out = tmp_path_factory.mktemp("jax_native")

    def build(source_name):
        lib = out / ("lib" + source_name.replace(".cpp", ".so"))
        if not lib.exists():
            subprocess.run(["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
                            "-pthread", str(Path(jbuild.__file__).parent / source_name),
                            "-o", str(lib)], check=True, capture_output=True)
        return str(lib)

    mp = pytest.MonkeyPatch()
    mp.setattr(jbuild, "build", build)
    for mod in (jcell_list, jbond_diff):
        mp.setattr(mod, "_lib", None)
        mp.setattr(mod, "_tried", False)
    assert jcell_list.available() and jbond_diff.available()
    yield
    mp.undo()


def _frames(seed=0, f=6, n=300, scale=8.0):
    """tests/test_native.py's frames."""
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(f, n, 3)) * scale).astype(np.float32)


def _sorted_rows(edges, mask):
    """Each frame's masked edges in (receiver, sender) order."""
    out = []
    for e, m in zip(edges, mask):
        e = e[m]
        out.append(e[np.lexsort((e[:, 1], e[:, 0]))])
    return out


def test_cell_list_equals_jax_and_the_dense_path(jax_native):
    frames = _frames()
    e, m = cell_list.radius_graph_frames(frames, 4.5)
    je, jm = jcell_list.radius_graph_frames(frames, 4.5)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(m, jm)
    de, dm = neighbors.radius_graph_frames_dense(frames, 4.5)
    assert e.shape == de.shape
    np.testing.assert_array_equal(m, dm)
    for got, want in zip(_sorted_rows(e, m), _sorted_rows(de, dm)):
        np.testing.assert_array_equal(got, want)
    # receiver-sorted through the (n-1, n-1) padding
    assert (np.diff(e[..., 0], axis=1) >= 0).all()


def test_cell_list_budget_overflow_raises():
    frames = np.random.default_rng(1).normal(size=(2, 64, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="edge budget"):
        cell_list.radius_graph_frames(frames, cutoff=100.0, max_edges=4)


def test_radius_graph_frames_routes_large_n_to_the_cell_list(jax_native):
    big = _frames(seed=2, f=2, n=400, scale=12.0)
    small = big[:, : neighbors.CELL_LIST_MIN_ATOMS - 1]
    before = cell_list.calls
    neighbors.radius_graph_frames(small, 5.0)
    assert cell_list.calls == before
    e, m = neighbors.radius_graph_frames(big, 5.0)
    assert cell_list.calls == before + 1
    je, jm = jcell_list.radius_graph_frames(big, 5.0)
    np.testing.assert_array_equal(e, je)
    np.testing.assert_array_equal(m, jm)


def _jittered(name="pentapeptide", n_frames=9, seed=0):
    """A reference frame and 8 samples with rising jitter: some valid, some
    with missing and spurious bonds."""
    z, frames, _ = synthetic_peptide(name, n_frames=n_frames, seed=seed)
    rng = np.random.default_rng(seed)
    gen = frames[1:] + rng.normal(scale=np.linspace(0.0, 0.6, n_frames - 1)[:, None, None],
                                  size=frames[1:].shape).astype(np.float32)
    return z, frames[0], gen


def test_bond_graph_extract_and_diff_equal_jax(jax_native):
    z, ref, gen = _jittered()
    radii = metrics._radii(z)
    edges = bond_diff.bond_graph_extract(ref, radii, 1.3)
    np.testing.assert_array_equal(edges, jbond_diff.bond_graph_extract(ref, radii, 1.3))
    missing, spurious = bond_diff.bond_graph_diff(gen, radii, edges, 1.3)
    jmissing, jspurious = jbond_diff.bond_graph_diff(gen, radii, edges, 1.3)
    np.testing.assert_array_equal(missing, jmissing)
    np.testing.assert_array_equal(spurious, jspurious)
    assert (missing + spurious == 0).any() and (missing + spurious > 0).any()


def test_evaluate_samples_routes_past_the_threshold_as_jax(jax_native):
    z, ref, gen = _jittered()
    before = bond_diff.calls
    cell = metrics.evaluate_samples(ref, gen, z, large_n_threshold=1)
    assert bond_diff.calls == before + 2          # all atoms, then heavy atoms
    dense = metrics.evaluate_samples(ref, gen, z)
    assert bond_diff.calls == before + 2
    want = jmetrics.evaluate_samples(ref, gen, z, large_n_threshold=1)
    for k in METRIC_KEYS:
        np.testing.assert_allclose(cell[k], want[k], rtol=1e-12, err_msg=k)
        np.testing.assert_allclose(cell[k], dense[k], rtol=1e-9, err_msg=k)
    for k in ("all_rmsds", "heavy_rmsds"):
        np.testing.assert_array_equal(cell[k], want[k])


def test_two_processes_building_at_once_both_load_a_working_library(tmp_path):
    """Each process builds into the same empty directory at the same
    moment; the temporary-name-then-rename gives each a whole library."""
    code = textwrap.dedent(f"""
        import sys
        from pathlib import Path
        import numpy as np
        from coarsegrainingvae_tpu_torch.native import build, cell_list
        build.BUILD_DIR = Path({str(tmp_path)!r})
        rng = np.random.default_rng(0)
        frames = (rng.normal(size=(2, 300, 3)) * 8.0).astype(np.float32)
        e, m = cell_list.radius_graph_frames(frames, 4.5)
        print(int(m.sum()), build.library_path("cell_list").name)
    """)
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    counts = {o.split()[0] for o, _ in outs}
    frames = _frames(f=2)
    _, want = neighbors.radius_graph_frames_dense(frames, 4.5)
    assert counts == {str(int(want.sum()))}
    libs = sorted(q.name for q in tmp_path.iterdir())
    assert libs == [outs[0][0].split()[1]]       # one library, no temporary left


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    from coarsegrainingvae_tpu_torch.native import build

    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(build, "_HERE", tmp_path)
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(build.BuildError, match="g\\+\\+ failed building broken.cpp"):
        build.load("broken", {})
