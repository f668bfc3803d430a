"""The harness end to end on the CPU at a tiny size (control flow only, no
device metric), the faults that ``correct`` has to catch, a cell added as
new files alone, and what the harness and the reference import."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from benchmark import control, run
from benchmark.conftest import tiny

ROOT = run.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
FIT = [w["name"] for w in BENCH["workloads"]
       if run.load_spec(ROOT, w["name"])["traffic"]["entry"] == "fit"]
PREDICT = [c for c in CELLS if c not in FIT]
CHAINS = [c for c in FIT
          if run.load_spec(ROOT, c)["traffic"]["chains"] > 1]
SEED = 2 ** 31 + 5


def _patched(monkeypatch):
    """Let ``control.plant`` rebind the program's names for this test only."""
    from spamtree_tpu_torch import api
    from spamtree_tpu_torch.model import core, mcmc

    from spamtree_tpu_torch.ops import linalg

    for mod, names in ((linalg, ("inv_chol",)),
                       (mcmc, ("predict", "predict_recompute", "make_step",
                               "_make_yhat_host", "gibbs_w",
                               "gibbs_beta_tausq")),
                       (core, ("predict_recompute", "pairwise_cov",
                               "pairwise_cov_diag")),
                       (api, ("predict_draws", "spamtree_predict"))):
        for n in names:
            monkeypatch.setattr(mod, n, getattr(mod, n))
    monkeypatch.setattr(mcmc.StepRunner, "step", mcmc.StepRunner.step)


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_cpu(cell):
    spec = tiny(run.load_spec(ROOT, cell))
    out = run.run_cell(spec, SEED, 1.0, False, device="cpu")
    assert out["device"]["platform"] == "cpu"
    assert out["device"]["memory_peak_bytes"] == 0
    assert set(out["metrics"]) == {m["name"] for m in spec["end_to_end"]
                                   if m["name"] != "peak_mem_gib"}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["checks"]) == set(spec["limits"])
    # the tiny size's chi-square tests are loose; the exact ones are not
    for k in ("tree_diff", "w_repeat_share"):
        if k in out["checks"]:
            assert out["checks"][k]["value"] == 0
    for k in ("quad_gap", "new_w_gap"):
        if k in out["checks"]:
            assert out["checks"][k]["value"] < 1e-5


@pytest.mark.parametrize("cell,fault,number", [
    *[(c, "pred_zero", "heldout_z2_gap") for c in FIT],
    *[(c, "state_unchanged", "w_repeat_share") for c in FIT],
    *[(c, "yhat_no_noise", "yhat_z2_gap") for c in FIT],
    *[(c, "half_blocks", None) for c in FIT],
    *[(c, "beta_zero", "heldout_err") for c in FIT],
    *[(c, "half_chains", "w_repeat_share") for c in CHAINS],
    *[(c, "pred_zero", "new_w_gap") for c in PREDICT],
    *[(c, "half_draws", "new_w_gap") for c in PREDICT],
    *[(c, "yhat_no_noise", "new_yhat_z2_gap") for c in PREDICT],
])
def test_fault_reads_not_correct(monkeypatch, cell, fault, number):
    _patched(monkeypatch)
    monkeypatch.setattr(run, "_runner", run._runner)
    if fault == "half_blocks":  # from the window on
        control.half_blocks(run)()
    else:
        control.plant(fault)
    spec = tiny(run.load_spec(ROOT, cell))
    out = run.run_cell(spec, SEED, 1.0, False, device="cpu")
    assert not out["correct"]
    if number is not None:
        c = out["checks"][number]
        assert not c["value"] <= c["limit"]


@pytest.mark.parametrize("fault,number,factor", [
    ("margins_swapped", "quad_gap", 1e3),
    ("w_no_data", "heldout_err", 1.5)])
@pytest.mark.parametrize("cell", FIT)
def test_fault_moves_its_number(monkeypatch, cell, fault, number, factor):
    """Faults read against the sound run at the same seed: at this size
    (few sites, a short chain) the margin swap reads above quad_gap's limit
    only in some cells, and sound runs already read heldout_err near the
    scale of w drawn without the data term."""
    spec = tiny(run.load_spec(ROOT, cell))
    sound = run.run_cell(spec, SEED, 1.0, False, device="cpu")
    _patched(monkeypatch)
    control.plant(fault)
    out = run.run_cell(spec, SEED, 1.0, False, device="cpu")
    assert (out["checks"][number]["value"]
            > factor * sound["checks"][number]["value"])


def test_new_cell_is_new_files_alone(tmp_path):
    """A throwaway cell: a traffic file, a limits file and an entry in a
    copy of BENCHMARK.json, with no file of the harness edited."""
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = dict(BENCH)
    bench["workloads"] = BENCH["workloads"] + [dict(
        name="c3_throwaway", config="biv_n1e5_ag10", traffic="throwaway",
        chips=1, why="a test's cell")]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    traffic = json.load(open(os.path.join(ROOT, "benchmark", "traffic",
                                          "single_all.json")))
    (tmp_path / "benchmark" / "traffic" / "throwaway.json").write_text(
        json.dumps(dict(traffic, chunk=7)))
    shutil.copy(os.path.join(ROOT, "benchmark", "limits",
                             "c3_biv1e5_single.json"),
                tmp_path / "benchmark" / "limits" / "c3_throwaway.json")
    spec = run.load_spec(str(tmp_path), "c3_throwaway")
    assert spec["traffic"]["chunk"] == 7
    out = run.run_cell(tiny(spec), SEED, 1.0, False, device="cpu")
    assert out["checks"]["tree_diff"]["value"] == 0


def _loaded(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + (
        "\nimport sys, json; print(json.dumps(sorted({k.split('.')[0] "
        "for k in sys.modules})))")], cwd=ROOT, capture_output=True,
        text=True, check=True, env=dict(os.environ, OMP_NUM_THREADS="1"))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_imports_nothing_of_the_program():
    mods = _loaded("import benchmark.data, benchmark.reference.density, "
                   "benchmark.reference.partition, "
                   "benchmark.reference.schedule, benchmark.reference.cost")
    assert not mods & {"jax", "jaxlib", "flax", "spamtree_tpu",
                       "spamtree_tpu_torch"}


def test_harness_run_loads_no_jax():
    mods = _loaded(
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark import run\n"
        "from benchmark.conftest import tiny\n"
        "spec = tiny(run.load_spec(run.ROOT, 'c3_biv1e5_single'))\n"
        "run.run_cell(spec, 7, 1.0, False, device='cpu')\n"
        "assert not run.forbidden_modules()")
    assert "spamtree_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN)


def test_exits_without_a_card():
    if __import__("torch").cuda.is_available():
        pytest.skip("this machine has a card")
    p = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=ROOT, capture_output=True, text=True)
    assert p.returncode == 2 and p.stdout == ""
