"""A later change adds a cell, a configuration, a traffic mix and a
per-layer metric as new files (and entries in BENCHMARK.json); the harness
finds each by its name without an edit to any file it already has."""

import json
import os
import shutil

import _paths
import pytest

from vpbench import spec


@pytest.fixture
def tree(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(_paths.BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(os.path.join(_paths.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    return root


def test_new_config_mix_metric_and_cell_are_found(tree):
    bench = tree / "benchmark"
    cfg = json.loads((bench / "configs" / "cogvideox5b-i2v-bf16.json").read_text())
    cfg["transformer"]["num_layers"] = 30
    (bench / "configs" / "new-model.json").write_text(json.dumps(cfg))
    mix = json.loads((bench / "traffic" / "clip49-dpm50-cfg6.json").read_text())
    mix["steps"] = 30
    (bench / "traffic" / "new-mix.json").write_text(json.dumps(mix))
    (bench / "checks" / "new-cell.json").write_text(json.dumps({"pred_rel_err": 0.5}))
    (bench / "metrics" / "new_metric.serve.py").write_text(
        "def read(run):\n    return 2.0 * run.steps\n")
    b = json.loads((tree / "BENCHMARK.json").read_text())
    b["configs"].append({"name": "new-model", "source": "https://example.org/new-model",
                         "file": "benchmark/configs/new-model.json", "reduced": [], "why": "test"})
    b["workloads"].append({"name": "new-cell", "config": "new-model", "traffic": "new-mix",
                           "chips": 1, "why": "test"})
    for m in b["end_to_end"]:
        if m["name"] == "serve_step_s":
            m["workloads"].append("new-cell")
    b["per_layer"].append({"name": "new_metric.serve", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "serve_step_s",
                           "workloads": ["new-cell"]})
    (tree / "BENCHMARK.json").write_text(json.dumps(b))

    cell = spec.load_cell("new-cell", root=str(tree))
    assert cell.config["transformer"]["num_layers"] == 30
    assert cell.traffic["steps"] == 30 and cell.checks == {"pred_rel_err": 0.5}
    assert [m["name"] for m in cell.per_layer] == ["new_metric.serve"]
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "serve_step_s"}
    assert spec.driver(cell.traffic).__name__ == "vpbench.drivers.denoise"

    class Run:
        steps = 3
    got = spec.read_metrics(cell.per_layer, Run(), bench_dir=str(bench))
    assert got == {"new_metric.serve": {"value": 6.0, "unit": "ms"}}


def test_a_metric_without_workloads_goes_to_every_cell_of_its_end_to_end_metric(tree):
    b = json.loads((tree / "BENCHMARK.json").read_text())
    b["per_layer"].append({"name": "everywhere.serve", "unit": "ms", "better": "lower",
                           "source": "device_trace", "layer": "device", "moves": "serve_step_s"})
    (tree / "BENCHMARK.json").write_text(json.dumps(b))
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"], root=str(tree))
        reports = any(m["name"] == "serve_step_s" for m in cell.end_to_end)
        assert ("everywhere.serve" in [m["name"] for m in cell.per_layer]) == reports


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tree):
    (tree / "benchmark" / "metrics" / "silent.serve.py").write_text(
        "def read(run):\n    return None\n")
    got = spec.read_metrics([{"name": "silent.serve", "unit": "%"}], object(),
                            bench_dir=str(tree / "benchmark"))
    assert got == {}


def test_every_metric_of_the_benchmark_has_a_reader_and_every_cell_its_files():
    b = json.loads(open(os.path.join(_paths.ROOT, "BENCHMARK.json")).read())
    for m in b["per_layer"]:
        assert callable(spec.metric_reader(m["name"]))
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.checks and cell.per_layer and cell.end_to_end
