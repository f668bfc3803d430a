"""The port's benchmark entry (``python -m spamtree_tpu_torch.bench``)
against the JAX package's ``bench.py``: the same data, configurations and
JSON line."""

import json
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

import bench as bench_jax
from spamtree_tpu_torch import bench

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _same(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        if x is None or y is None:
            assert x is None and y is None
        else:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("make", [
    lambda m: m.CONFIGS[1]["maker"](),
    lambda m: m.CONFIGS[2]["maker"](),
    lambda m: m.make_multivariate(500, 2),
    lambda m: m.make_multivariate(400, 3, seed=3, miss=0.2),
    lambda m: m.make_multivariate(400, 3, imbalance=(0.55, 0.3, 0.15)),
    lambda m: m.make_multivariate(300, 2, imbalance=(0.8, 0.2)),
    lambda m: m.make_univariate(333, seed=11, miss=0.3),
], ids=["config1", "config2", "mv_q2", "mv_q3_seed3", "mv_imbalance_q3",
        "mv_imbalance_q2", "uni_seed11"])
def test_makers_give_bench_arrays_bit_for_bit(make):
    """The port's copies of bench.py's data makers give its arrays, bit
    for bit (y with its NaNs, y_full, the mask, X, coords, mv)."""
    _same(make(bench), make(bench_jax))


def test_configs_are_bench_configs():
    """Names, depths, chunk and kwargs of every configuration."""
    assert list(bench.CONFIGS) == list(bench_jax.CONFIGS)
    for k, c in bench_jax.CONFIGS.items():
        got = {x: v for x, v in bench.CONFIGS[k].items() if x != "maker"}
        assert got == {x: v for x, v in c.items() if x != "maker"}, k


FAKE_RUN = dict(config="uni_n625_readme", n=625, iters=3200, ips=812.3456,
                rmspe=0.28412, sd_y=1.5511, accept=0.2831, mcmc_time=3.94,
                setup_time=12.07, setup_breakdown={"tree_s": 0.02},
                tflops_per_sec=0.0101, bandwidth_util=0.00312, n_chains=1)


@pytest.mark.parametrize("argv", [["--repeats", "1"], ["--repeats", "3"],
                                  ["--repeats", "2", "--n_chains", "2"]],
                         ids=["one_repeat", "three_repeats", "chains"])
def test_json_line_has_bench_keys(argv, monkeypatch, capsys):
    """Both mains, their run_config returning the same dict: the port's
    JSON line has exactly bench.py's keys in bench.py's order, and the
    same values."""
    n_chains = 2 if "--n_chains" in argv else 1
    fake = lambda *a, **k: dict(FAKE_RUN, n_chains=n_chains)
    monkeypatch.setattr(bench_jax, "run_config", fake)
    monkeypatch.setattr(bench, "run_config", fake)
    monkeypatch.setattr(sys, "argv", ["bench.py", "--config", "1", *argv])
    bench_jax.main()
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert bench.main(["--config", "1", "--device", "cpu", *argv]) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(got) == list(want)
    assert got == want


def test_entry_runs_on_the_cpu(capsys):
    """A short config-1 run on the CPU: the run line (launches, replays,
    each part's work and its keep-loop calls) and a JSON line whose
    figures hold together; bandwidth_util, a share of the card's memory
    rate, is null off the card."""
    assert bench.main(["--config", "1", "--device", "cpu", "--keep", "8",
                       "--burn", "8", "--repeats", "1", "--chunk", "4"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    run = json.loads(next(x for x in lines if x.startswith("bench run: "))
                     [len("bench run: "):])
    line = json.loads(lines[-1])
    assert run["device"] == "cpu" and run["k1_launches"] == 0
    assert run["part_work"]["A"]["calls"] == 16
    assert run["part_work"]["T1"]["calls"] == 8
    assert run["flops_per_kept_sample"] > 0
    assert line["iters"] == 8 + 16 and line["repeats"] == 1
    assert np.isfinite(line["rmspe"]) and line["tflops_per_sec"] > 0
    assert line["bandwidth_util"] is None
    assert "work_count_s" in line["setup_breakdown_s"]


def test_entry_refuses_without_cuda(capsys, monkeypatch):
    """--device cuda without a card prints bench.py's error line and
    exits 3; it never runs on the CPU instead."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(bench, "run_config", lambda *a, **k: called.append(1))
    assert bench.main(["--config", "3"]) == 3
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["value"] == 0.0 and "CUDA is not available" in line["error"]
    assert set(line) == {"metric", "value", "unit", "vs_baseline", "error"}
    assert not called


def test_port_never_imports_the_root_bench():
    """The port and chip_smoke.py take the data makers from
    spamtree_tpu_torch.bench, never from the JAX side's bench.py."""
    pat = re.compile(r"^\s*(import\s+bench\b|from\s+bench\s+import)", re.M)
    files = sorted((REPO / "spamtree_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    for f in files:
        assert not pat.search(f.read_text()), f
