"""BENCHMARK.json and the files it names: the contract's shape, and every
cell, configuration, traffic mix, limit and metric reader found by name."""

import json
import os
import re

import pytest

from benchmark import run

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert all(NAME.match(n) for n in names)
    assert len(set(names)) == len(names)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    spec = run.load_spec(ROOT, cell)
    assert spec["cell"]["chips"] == 1
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert spec["traffic"]["entry"] in ("fit", "predict")
    assert spec["limits"]["tree_diff"] == 0
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert m["moves"] in reported
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert hasattr(run.metric_module(ROOT, m["name"]), "read")


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(conf):
    f = json.load(open(os.path.join(ROOT, conf["file"])))
    assert f["name"] == conf["name"] and f["source"] == conf["source"]
    assert f["reduced"] == conf["reduced"] == []
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_reader_agrees(m):
    mod = run.metric_module(ROOT, m["name"])
    assert mod.SOURCE == m["source"]
    if "layer" in m:
        assert mod.LAYER == m["layer"] and mod.MOVES == m["moves"]
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_readers_return_nothing_without_readings():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert run.metric_module(ROOT, m["name"]).read(
            dict(config=None, traffic=None)) is None
