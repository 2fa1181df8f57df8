"""``BENCHMARK.json`` against the benchmark's contract, and the files each
entry names."""

import json
import re

import pytest

from benchmark import harness
from conftest import ROOT

BENCH = ROOT / "benchmark"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert manifest["command"] == ["python3", "benchmark/run.py"]
    assert manifest["paths"] == ["benchmark"]
    assert all(PATH.match(p) and ".." not in p and not p.startswith("/")
               for p in manifest["paths"])
    assert isinstance(manifest["run_seconds"], int) and 1 <= manifest["run_seconds"] <= 51
    assert len(json.dumps(manifest)) <= 64 * 1024


def test_full_check_fits_with_24_cells(manifest):
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_lines(manifest):
    groups = [manifest["configs"], manifest["workloads"], manifest["end_to_end"],
              manifest["per_layer"]]
    for group in groups:
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and len(c["reduced"]) <= 16
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and NAME.match(w["config"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert _line(m["layer"])


def test_bounds(manifest):
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    setup = [m for m in manifest["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]


def test_every_file_named_exists(manifest):
    for c in manifest["configs"]:
        path = ROOT / c["file"]
        assert path.is_file() and c["file"].startswith("benchmark/")
        assert json.loads(path.read_text())["name"] == c["name"]
        assert c["reduced"] == []
    configs = {c["name"] for c in manifest["configs"]}
    used = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs
        used.add(w["config"])
        traffic = json.loads((BENCH / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "kinds" / f"{traffic['kind']}.py").is_file()
        assert json.loads((BENCH / "workloads" / f"{w['name']}.json").read_text())["limits"]
    assert used == configs
    for m in manifest["per_layer"]:
        assert harness.reader_path(m["name"]) is not None, m["name"]
    pairs = [(w["config"], w["traffic"]) for w in manifest["workloads"]]
    assert len(pairs) == len(set(pairs))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def test_each_cell_reports_and_each_layer_metric_moves_what_its_cells_report(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    cells = [w["name"] for w in manifest["workloads"]]
    for m in manifest["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(moved, cell), (m["name"], cell)
    for cell in cells:
        own = [m for m in manifest["end_to_end"] if _reports(m, cell)]
        assert "setup_s" in {m["name"] for m in own} and len(own) >= 2
        assert any(_reports(m, cell) for m in manifest["per_layer"])


def test_layers_are_named_alike(manifest):
    layers = {m["layer"] for m in manifest["per_layer"]}
    assert layers == {"model step", "train step", "kernels", "device", "data loader",
                      "registry"}


@pytest.mark.parametrize("metric,file", [
    ("device_idle.train", "device_idle.py"),
    ("mfu.cls_serve", "mfu.py"),
    ("mfu.train", "mfu.train.py"),
    ("roofline.double_conv.seg_serve", "roofline.double_conv.py"),
    ("mean_group.request", "mean_group.request.py"),
])
def test_a_metric_is_read_by_its_own_file_or_its_longest_prefix(metric, file):
    assert harness.reader_path(metric) == BENCH / "metrics" / file
    assert harness.reader_path("no_such_metric.train") is None
