"""Fixtures of the benchmark's own tests (``python -m pytest benchmark``):
tiny cells on the CPU, and the card's tests, marked ``cuda``, which skip
where CUDA is absent."""

import copy
import os

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips where CUDA is absent")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: several test workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def tiny(spec: dict, n_per_q: int = 400) -> dict:
    """A copy of a cell's spec at a size the CPU runs in seconds: the
    configuration's sites cut to ``n_per_q`` per margin, a burn of 10, a
    few kept draws; the predict cell's fit and new sites cut alike."""
    spec = copy.deepcopy(spec)
    spec["config"]["data"]["n_per_q"] = n_per_q
    t = spec["traffic"]
    if t["entry"] == "fit":
        t.update(burn=10, planned_iters_per_s=20, min_keep=5)
    else:
        t["fit"].update(burn=10, keep=12, chunk=4)
        t.update(m_new=50, planned_calls_per_s=1)
    return spec
