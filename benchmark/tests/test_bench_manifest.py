"""``BENCHMARK.json`` against the benchmark's contract: names, units, keys,
bounds, files, and the per-layer metrics each with a reader."""

import json
import os
import re

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(os.path.join(REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text \
        and "\t" not in text


def test_top_level_and_command(bench):
    assert set(bench) == TOP
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32 and all(line(w) for w in bench["command"])
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(REPO, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert os.path.exists(os.path.join(REPO, c["file"]))
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
        assert w["config"] in {c["name"] for c in bench["configs"]}
        assert os.path.exists(os.path.join(REPO, "benchmark", "traffic", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(REPO, "benchmark", "reference", "limits",
                                           w["name"] + ".json"))
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert {c["name"] for c in bench["configs"]} <= {w["config"] for w in bench["workloads"]}
    for group in ("configs", "workloads"):
        names = [x["name"] for x in bench[group]]
        assert len(set(names)) == len(names)
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(set(names)) == len(names)
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES


def test_end_to_end_bounds(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_per_layer_metrics_have_a_reader(bench):
    e2e = {m["name"] for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert line(m["layer"]) and m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(REPO, "benchmark", "metrics", m["name"] + ".py"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_each_cell_reports_what_its_layer_metrics_move(bench):
    cells = [w["name"] for w in bench["workloads"]]
    held = {m["name"]: set(m.get("workloads", cells)) for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m.get("workloads", cells)) <= held[m["moves"]], m["name"]
    for c in cells:
        reported = {name for name, where in held.items() if c in where}
        assert "setup_s" in reported and len(reported) >= 2, c
        assert any(c in m.get("workloads", cells) for m in bench["per_layer"]), c
