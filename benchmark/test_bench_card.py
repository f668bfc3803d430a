"""The lower-precision control on the card, at a size a test run holds:
the fit cells' numbers with the reference put in the program's place in
float32 with TF32 products, and the program itself with TF32 on, both come
out as not correct (``python -m pytest benchmark -m cuda`` on the card)."""

import pytest

from benchmark import control, run
from benchmark.conftest import tiny

ROOT = run.ROOT


@pytest.mark.cuda
def test_reference_in_tf32_is_not_correct(card, monkeypatch):
    monkeypatch.setattr(run, "check_fit", run.check_fit)
    control.ref_in_tf32(run)
    spec = tiny(run.load_spec(ROOT, "c3_biv1e5_single"), n_per_q=5000)
    out = run.run_cell(spec, 2 ** 31 + 9, 2.0, False, device=card)
    assert not out["correct"]
    c = out["checks"]["quad_gap"]
    assert not c["value"] <= c["limit"]


@pytest.mark.cuda
def test_program_in_tf32_is_not_correct(card):
    import torch

    spec = tiny(run.load_spec(ROOT, "c3_biv1e5_single"), n_per_q=5000)
    control.tf32_on()
    try:
        out = run.run_cell(spec, 2 ** 31 + 9, 2.0, False, device=card)
        assert not out["correct"]
    except RuntimeError as e:  # the initial factors fail in TF32
        assert "Cholesky" in str(e)
    finally:
        control.tf32_on(False)
    assert not torch.backends.cuda.matmul.allow_tf32
