"""``correct`` at a tiny width on the CPU: sound runs of every cell come out
correct; the lower-precision control and each fault a cell can have
(a state left unchanged, half the batch left out, the exchange between
chips left out) come out not correct."""
import json

import pytest

from cgbench import compare, harness, registry

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
ONE_CHIP = [w["name"] for w in BENCH["workloads"] if w["chips"] == 1]
MULTI = [w["name"] for w in BENCH["workloads"] if w["chips"] > 1]


def run(root, name, seed, fault=None, trace=False):
    cell = registry.resolve(name, root)
    results = harness.run(cell, seed, 0.0, trace, device="cpu", fault=fault, root=root)
    line, _ = harness.compose(cell, results, trace, 0.0, platform="cpu")
    return line


@pytest.mark.parametrize("name", ONE_CHIP)
def test_a_sound_run_is_correct(tiny_root, name):
    line = run(tiny_root, name, 2**31 + 7)
    assert line["correct"] is True, line["checks"]
    assert line["attempted"] > 0 and line["failed"] == 0


@pytest.mark.parametrize("name", ONE_CHIP)
@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch"])
def test_a_broken_step_is_not_correct(tiny_root, name, fault):
    assert run(tiny_root, name, 2**31 + 8, fault)["correct"] is False


@pytest.mark.parametrize("name", ONE_CHIP)
def test_the_fp8_control_is_not_correct(tiny_root, name):
    cell = registry.resolve(name, tiny_root)
    inp = harness.Inputs(cell, 9)
    values = compare.numbers(inp.reference(cell, "cpu", precision="fp8"),
                             inp.reference(cell, "cpu"))
    assert not compare.judge(values, cell.workload["limits"]), values


@pytest.mark.parametrize("name", MULTI)
@pytest.mark.parametrize("fault", [None, "no_exchange"])
def test_data_parallel_ranks_are_correct_only_with_their_exchange(tiny_root, name, fault):
    line = run(tiny_root, name, 13, fault)
    assert line["correct"] is (fault is None), line["checks"]
    assert line["device"]["count"] == registry.resolve(name, tiny_root).chips


def test_a_traced_run_reads_its_per_layer_metrics(tiny_root):
    line = run(tiny_root, "dip_dense.train_b32", 21, trace=True)
    assert line["correct"] is True
    assert "epoch.host_launches_per_step" in line["metrics"]
    assert line["device"]["window_s"] > 0 and "breakdown" in line


@pytest.mark.gpu
@pytest.mark.parametrize("name", ONE_CHIP)
def test_a_cell_on_the_card_is_correct(card, name):
    cell = registry.resolve(name)
    line, _ = harness.compose(cell, harness.run(cell, 2**31 + 99, 1.0, False), False, 0.0)
    assert line["correct"] is True, line["checks"]
