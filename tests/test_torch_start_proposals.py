"""The theta proposal's decision terms at bench config 3's kind of start
(tests/_start_proposals.py at n = 600): the port's decision-only sweep
gives the JAX package's new_logdet, q_new, q_cur, jacobian and ok on the
same tree, start, w and proposals, at mcmcsd 1e-4, 1e-2 and 1e-12; in
float64 to rtol 1e-9 of each term's magnitude (as tests/test_torch_core.py),
in float32 to 1e-4 of the largest term (the terms cancel to the
log-accept from magnitudes ~1e3, so f32 rounding shows there first).  The
refusals of a u = 0 draw at the wider proposals are the log-accept's
underflow in both packages, never a failed Cholesky."""

import numpy as np
import pytest
import torch

import _start_proposals as sp

TERMS = ("new_logdet", "q_new", "q_cur", "jacobian", "logdetCi")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_start_proposal_terms_match_jax(dtype):
    rows = sp.main(["--n_per_q", "300", "--draws", "2", "--dtype", dtype])
    assert len(rows) == 6
    rtol = 1e-9 if dtype == "float64" else 1e-4
    for r in rows:
        p, j = r["port"], r["jax"]
        assert p["ok"] == j["ok"], r
        scale = max(abs(j[k]) for k in TERMS)
        for k in TERMS:
            np.testing.assert_allclose(p[k], j[k], rtol=rtol,
                                       atol=rtol * scale, err_msg=str(r))
        if dtype == "float64":
            assert p["refused_by"] == j["refused_by"], r
        assert p["refused_by"] != "ok", r
    # the narrowest proposal installs on both sides
    assert all(r["port"]["refused_by"] == r["jax"]["refused_by"] == ""
               for r in rows if r["mcmcsd"] == 1e-12)
