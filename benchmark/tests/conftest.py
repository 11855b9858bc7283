"""CPU tests of the benchmark: ``python -m pytest benchmark/tests -q``.

The harness runs here at a tiny width (``tiny_root``: a copy of
``BENCHMARK.json`` and ``benchmark/`` whose configurations have n_basis 16,
n_rbf 4 and two layers each way, and whose traffic has 4 rows and epochs
of 4 steps); tests marked ``gpu`` need a CUDA card and skip without one.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
for _path in (str(ROOT), str(BENCH)):
    if _path not in sys.path:
        sys.path.insert(0, _path)

TINY_MODEL = {"n_basis": 16, "n_rbf": 4, "enc_nconv": 2, "dec_nconv": 2}


def pytest_configure(config):
    config.addinivalue_line("markers", "gpu: needs a CUDA device; skips without one")


def make_tiny_root(dst: Path) -> Path:
    shutil.copy(ROOT / "BENCHMARK.json", dst / "BENCHMARK.json")
    shutil.copytree(BENCH, dst / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    for path in (dst / "benchmark" / "configs").glob("*.json"):
        cfg = json.loads(path.read_text())
        cfg.update(TINY_MODEL)
        path.write_text(json.dumps(cfg))
    for path in (dst / "benchmark" / "traffic").glob("*.json"):
        traffic = json.loads(path.read_text())
        traffic.update(batch_size=4 * (2 if "dp4" in path.name else 1), epoch_steps=4)
        path.write_text(json.dumps(traffic))
    return dst


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_tiny_root(tmp_path_factory.mktemp("tiny"))


@pytest.fixture
def card():
    """Skips the test without a CUDA card."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)
