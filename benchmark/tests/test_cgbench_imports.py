"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the port. Module names are compared by their
top-level name whole: the port's name begins with the JAX package's."""
import ast
import subprocess
import sys

import pytest

from cgbench import guard, registry

REFERENCE = registry.BENCH_DIR / "cgbench" / "reference"
PORT, JAX_PACKAGE = "coarsegrainingvae_tpu_torch", "coarsegrainingvae_tpu"


def test_top_level_names_are_compared_whole():
    assert guard.forbidden_loaded([PORT, f"{PORT}.train.trainer", "numpy", "jaxtyping"]) == []
    assert guard.forbidden_loaded(["jax.numpy", f"{JAX_PACKAGE}.models", "flax"]) == \
        ["coarsegrainingvae_tpu", "flax", "jax"]


def imported(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(REFERENCE.glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_torch_numpy_and_itself_alone(path):
    assert imported(path) <= {"__future__", "math", "dataclasses", "typing", "types",
                              "importlib", "numpy", "torch", "cgbench"}


def test_loading_the_reference_loads_nothing_of_the_port_or_jax():
    code = ("import sys; sys.path[:0] = [%r]; import cgbench.reference.train, cgbench.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(registry.BENCH_DIR))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    loaded = set(eval(out.stdout.strip().splitlines()[-1]))
    assert not loaded & {PORT, JAX_PACKAGE, "jax", "jaxlib", "flax"}


def test_a_run_loads_neither_jax_nor_the_jax_package(tiny_root):
    code = f"""
import sys, json
sys.path[:0] = [{str(registry.ROOT)!r}, {str(registry.BENCH_DIR)!r}]
from pathlib import Path
from cgbench import harness, registry, guard
cell = registry.resolve("dip_dense.train_b32", Path({str(tiny_root)!r}))
res = harness.run(cell, 5, 0.0, False, device="cpu", root=Path({str(tiny_root)!r}))
print(json.dumps([guard.forbidden_loaded(), res[0]["forbidden"],
                  "coarsegrainingvae_tpu_torch" in sys.modules]))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    after, during, port = eval(out.stdout.strip().splitlines()[-1].replace("false", "False")
                               .replace("true", "True"))
    assert after == [] and during == [] and port


def test_run_refuses_without_enough_cards():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the refusal needs a machine without one")
    out = subprocess.run([sys.executable, str(registry.BENCH_DIR / "run.py"), "--workload",
                          "dip_dense.train_b32", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True)
    assert out.returncode != 0 and out.stdout.strip() == ""
