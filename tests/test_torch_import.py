"""The PyTorch port never imports JAX, flax, optax, orbax, msgpack or the
JAX package (its flax msgpack codec is written by hand); nor do its example
tools (``examples/*_torch.py``) and ``chip_smoke.py``."""
import pathlib
import re
import subprocess
import sys

import torch

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "coarsegrainingvae_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "coarsegrainingvae_tpu")
EXAMPLES = sorted((ROOT / "examples").glob("*_torch.py"))


def test_port_imports_no_jax_in_a_fresh_process():
    code = (
        "import importlib, pkgutil, sys\n"
        "import coarsegrainingvae_tpu_torch as pkg\n"
        "for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import importlib.util\n"
        f"for path in {[str(p) for p in EXAMPLES]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('example', path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([n for n in sys.modules if n.startswith(pkg.__name__)]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert int(res.stdout.split()[0]) >= 15          # every module was imported
    assert {p.name for p in EXAMPLES} >= {
        "analysis_demo_torch.py", "profile_kernels_torch.py", "profile_flagship_torch.py",
        "accuracy_ab_torch.py", "quickstart_torch.py", "validity_census_torch.py"}


def test_port_sources_name_no_jax_module():
    pattern = re.compile(r"^\s*(import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.M)
    hits = [str(p.relative_to(ROOT)) for p in [*PKG.rglob("*.py"), ROOT / "chip_smoke.py",
                                               *EXAMPLES]
            if pattern.search(p.read_text())]
    assert hits == []


def test_run_file_and_analysis_modules_import_no_jax_or_msgpack():
    """The flax msgpack codec, the converters, profiling, VMD and analysis
    load in a fresh process without msgpack, flax, JAX or the JAX package."""
    code = (
        "import sys\n"
        "import coarsegrainingvae_tpu_torch.utils.flax_msgpack\n"
        "import coarsegrainingvae_tpu_torch.convert\n"
        "import coarsegrainingvae_tpu_torch.utils.profiling\n"
        "import coarsegrainingvae_tpu_torch.utils.vmd\n"
        "import coarsegrainingvae_tpu_torch.eval.analysis\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert {p.name for p in (PKG / "utils").glob("*.py")} >= {
        "flax_msgpack.py", "profiling.py", "vmd.py"}


def test_parallel_package_imports_no_jax():
    """The multi-GPU modules (parallel.mesh, parallel.halo, parallel.launch)
    load in a fresh process without JAX or the JAX package."""
    code = (
        "import sys\n"
        "import coarsegrainingvae_tpu_torch.parallel.mesh\n"
        "import coarsegrainingvae_tpu_torch.parallel.halo\n"
        "import coarsegrainingvae_tpu_torch.parallel.launch\n"
        f"bad = sorted(n for n in sys.modules if n.split('.')[0] in {FORBIDDEN!r})\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert {p.name for p in (PKG / "parallel").glob("*.py")} >= {
        "__init__.py", "mesh.py", "halo.py", "launch.py"}
