"""The harness finds configurations, cells and per-layer metrics by name,
and a new one needs only new files and a BENCHMARK.json entry."""
import json
import shutil

import pytest

from cgbench import compare, harness, program, registry

BENCH = json.loads((registry.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_resolves_to_its_files(name):
    cell = registry.resolve(name)
    entry = {w["name"]: w for w in BENCH["workloads"]}[name]
    assert cell.chips == entry["chips"] and cell.config["name"] == entry["config"]
    assert cell.traffic["name"] == entry["traffic"]
    assert set(cell.workload["limits"]) == set(compare.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "train_samples_per_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    for metric in cell.per_layer:
        assert callable(registry.reader(metric["name"]))


def test_every_per_layer_metric_has_a_reader_and_moves_an_end_to_end_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for metric in BENCH["per_layer"]:
        assert metric["moves"] in e2e
        assert (registry.BENCH_DIR / "metrics" / f"{metric['name']}.py").is_file()


def test_configuration_files_are_their_own_and_list_what_they_cut():
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    for entry in BENCH["configs"]:
        cfg = json.loads((registry.ROOT / entry["file"]).read_text())
        assert cfg["reduced"] == entry["reduced"] and cfg["source"] == entry["source"]
        assert set(cfg["reduced"]) <= set(cfg["assumed"])


# a copy of a configuration, and configurations that change the decoder and
# switch on the steric term and the warm-up ramps
NEW_CONFIGS = {
    "copy": ("dipeptide_dense", {}),
    "dense_cross_zeta": ("dipeptide_dense", {"dec_type": "cross", "zeta": 200.0,
                                             "zeta_warmup": 2, "steric_margin": 0.4}),
    "dense_painn_lr_warmup": ("dipeptide_dense", {"dec_type": "painn", "lr_warmup": 2}),
    "sparse_cross_zeta": ("dipeptide_sparse", {"dec_type": "cross", "zeta": 200.0,
                                               "steric_data_margin": True}),
}


def add_cell(root, tag, base, changes):
    """A configuration ``base`` with ``changes``, a traffic mix, a cell and a
    metric, added to the copy ``root`` as files and entries alone."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    base_entry = {c["name"]: c for c in bench["configs"]}[base]
    cfg_entry = dict(base_entry, name=f"cfg_{tag}", file=f"benchmark/configs/cfg_{tag}.json")
    cfg = dict(json.loads((root / base_entry["file"]).read_text()), **changes)
    (root / cfg_entry["file"]).write_text(json.dumps(cfg))
    (root / "benchmark" / "traffic" / "train_b8.json").write_text(json.dumps(
        dict(json.loads((root / "benchmark/traffic/train_b32.json").read_text()), batch_size=8)))
    cell = f"new_{tag}.train_b8"
    (root / "benchmark" / "workloads" / f"{cell}.json").write_text(
        (root / "benchmark/workloads/dip_dense.train_b32.json").read_text())
    (root / "benchmark" / "metrics" / "step.count.py").write_text(
        "def read(ctx):\n    return float(ctx.trace.steps)\n")
    bench["configs"].append(cfg_entry)
    bench["workloads"].append({"name": cell, "config": cfg_entry["name"], "traffic": "train_b8",
                               "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "step.count", "unit": "steps", "better": "higher",
                               "source": "device_trace", "layer": "entry / epoch program",
                               "moves": "train_samples_per_s", "workloads": [cell]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return cell


@pytest.mark.parametrize("tag", sorted(NEW_CONFIGS))
def test_a_cell_a_configuration_and_a_metric_are_added_by_files_alone(tiny_root, tmp_path, tag):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    base, changes = NEW_CONFIGS[tag]
    cell = registry.resolve(add_cell(root, tag, base, changes), root)
    assert cell.traffic["batch_size"] == 8
    exp = program.experiment(cell.config, cell.traffic)
    for key, value in changes.items():
        assert getattr(exp.model if hasattr(exp.model, key) else exp.train, key) == value
    results = harness.run(cell, 11, 0.0, True, device="cpu", root=root)
    line, _ = harness.compose(cell, results, True, 0.0, platform="cpu")
    assert line["correct"] is True, line["checks"]
    assert line["metrics"]["step.count"]["value"] == cell.traffic["epoch_steps"]


def test_the_steric_term_reaches_the_reference(tiny_root, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    base, changes = NEW_CONFIGS["dense_cross_zeta"]
    with_zeta = registry.resolve(add_cell(root, "z", base, changes), root)
    without = registry.resolve(add_cell(root, "nz", base, dict(changes, zeta=0.0)), root)
    inp = harness.Inputs(with_zeta, 3)
    a, b = inp.reference(with_zeta, "cpu")["losses"], inp.reference(without, "cpu")["losses"]
    assert a[0] == b[0]            # the ramp starts at 0
    assert a[2] > b[2]             # and reaches zeta at step 3


@pytest.mark.parametrize("key,value", [("h_project", True), ("zeta_typo", 1.0), ("eta_h", 0.5)])
def test_a_key_that_neither_side_reads_is_refused(tiny_root, key, value):
    cell = registry.resolve("dip_dense.train_b32", tiny_root)
    with pytest.raises(ValueError, match="read by neither"):
        program.experiment(dict(cell.config, **{key: value}), cell.traffic)


def test_a_per_layer_metric_without_workloads_is_refused(tiny_root, tmp_path):
    root = tmp_path / "copy"
    shutil.copytree(tiny_root, root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    del bench["per_layer"][0]["workloads"]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    with pytest.raises(ValueError, match="list no workloads"):
        registry.resolve("dip_dense.train_b32", root)
