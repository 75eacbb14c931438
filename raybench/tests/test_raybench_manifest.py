"""BENCHMARK.json against the benchmark's contract: keys, names, units,
which cell reports which metric, and that every name it gives is a file
of the benchmark."""

from __future__ import annotations

import json
import os
import re

import pytest

from conftest import HOME, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def _module(name):
    from raybench import manifest

    return manifest.metric(ROOT, name)


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["raybench"]
    assert bench["command"] == ["python3", "raybench/run.py"]
    assert 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    four = [w for w in bench["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(bench["workloads"]) // 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_units_and_text(bench):
    entries = (bench["configs"] + bench["workloads"] + bench["end_to_end"]
               + bench["per_layer"])
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert TEXT.match(w["why"])
    for c in bench["configs"]:
        assert TEXT.match(c["why"]) and TEXT.match(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in {"lower", "higher"}
    for m in bench["per_layer"]:
        assert TEXT.match(m["layer"])
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in bench[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(metrics) == len(set(metrics))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m for m in bench["end_to_end"]}["setup_s"]["bound"] \
        == 0.25


def _reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_each_cell_reports_enough(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"] if _reports(m, w["name"])]
        layer = [m for m in bench["per_layer"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert layer, w["name"]


def test_moves_is_reported_where_the_metric_is(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_name_is_a_file(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"raybench/configs/{c['name']}.json"
        with open(os.path.join(ROOT, c["file"])) as fh:
            cfg = json.load(fh)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert os.path.isfile(os.path.join(ROOT, cfg["mesh"]))
    for w in bench["workloads"]:
        for sub, name in (("traffic", w["traffic"]), ("cells", w["name"])):
            assert os.path.isfile(os.path.join(HOME, sub, f"{name}.json"))


def test_metric_modules_agree_with_the_manifest(bench):
    for m in bench["end_to_end"]:
        assert _module(m["name"]).UNIT == m["unit"]
    for m in bench["per_layer"]:
        mod = _module(m["name"])
        assert (mod.UNIT, mod.LAYER, mod.MOVES) == (m["unit"], m["layer"],
                                                    m["moves"])


def test_run_seconds_fit_the_largest_check(bench):
    cells = 24
    runs = 2 + 14 * cells
    total = runs * (bench["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total <= 43200


def test_paths_hold_only_the_benchmark(bench):
    for path in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_./-]{1,200}$", path)
        assert not path.startswith("/") and ".." not in path.split("/")
