"""Batched inverse Cholesky factor of small SPD blocks: kernel K1.

``inv_chol`` is the wrapper of the CUDA kernel ``csrc/inv_chol.cu``, which
replaces the Pallas TPU kernels ``spamtree_tpu/ops/pallas_chol.py::
inv_chol_lanes`` and ``chol_and_inv_lanes`` (the latter as ``write_l``).
``inv_chol_plain`` is the plain PyTorch version of the same function: the
wrapper uses it for tensors on the CPU, and the tests and ``chip_smoke.py``
hold the kernel against it.
"""

from __future__ import annotations

import ctypes

import torch

from spamtree_tpu_torch.ops import kernel_counts
from spamtree_tpu_torch.utils.cost import counted

MAX_S = 128  # float32; float64 stops at MAX_S_F64 (csrc/inv_chol.cu)
MAX_S_F64 = 64
WIDE_S = 96  # float32 blocks past it take the kernel's 128-thread form

_FNS = {torch.float32: "st_inv_chol_f32", torch.float64: "st_inv_chol_f64"}
_bound: dict = {}


def max_s(dtype) -> int:
    """The largest S the kernel takes in ``dtype``."""
    return MAX_S_F64 if dtype == torch.float64 else MAX_S


def _kernel(dtype):
    """The ctypes entry point for ``dtype``; builds the library at first use."""
    if dtype not in _bound:
        from spamtree_tpu_torch.ops import _build

        fn = getattr(_build.load("inv_chol"), _FNS[dtype])
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[dtype] = fn
    return _bound[dtype]


def inv_chol_plain(a: torch.Tensor, write_l: bool = False):
    """(B, S, S) SPD -> Linv = chol(a)^-1 (and L with ``write_l``).

    A block whose factorisation fails comes back all NaN, which the callers
    read as ok=False -- the same outcome as the kernel's NaN pivots.
    ``torch.linalg.cholesky_ex`` itself leaves finite garbage there."""
    L, info = torch.linalg.cholesky_ex(a)
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    Linv = torch.linalg.solve_triangular(L, eye.expand_as(a), upper=False)
    bad = (info != 0)[:, None, None]
    Linv = torch.where(bad, float("nan"), Linv)
    if write_l:
        return torch.where(bad, float("nan"), L), Linv
    return Linv


def inv_chol_cost(B: int, S: int, write_l: bool, dtype) -> tuple:
    """(flops, bytes) of one K1 call on (B, S, S): A read once, Linv (and
    L with ``write_l``) written once; S^3/3 operations per block for the
    factor and as many for its inverse."""
    return (B * 2 * S ** 3 / 3,
            (3 if write_l else 2) * B * S * S * dtype.itemsize)


@counted(lambda a, write_l: inv_chol_cost(a.shape[:-2].numel(), a.shape[-1],
                                          write_l, a.dtype))
def inv_chol(a: torch.Tensor, write_l: bool = False):
    """Batched (B, S, S) SPD -> Linv (or (L, Linv) with ``write_l``), both
    lower triangular.  CUDA tensors launch the kernel; CPU tensors take
    ``inv_chol_plain``; each launch counts as ``k1_launches``
    (``ops.kernel_counts``)."""
    if a.device.type == "cpu":
        return inv_chol_plain(a, write_l)
    if a.dtype not in _FNS:
        raise TypeError(f"inv_chol: dtype {a.dtype} not in (float32, float64)")
    if a.dim() != 3 or a.shape[1] != a.shape[2]:
        raise ValueError(f"inv_chol: expected (B, S, S), got {tuple(a.shape)}")
    B, S = a.shape[0], a.shape[1]
    if B < 1 or not 1 <= S <= max_s(a.dtype):
        raise ValueError(f"inv_chol: need B >= 1 and 1 <= S <= "
                         f"{max_s(a.dtype)} in {a.dtype}, got B={B}, S={S}")
    if not a.is_contiguous():
        raise ValueError("inv_chol: input must be contiguous")
    if a.device.type != "cuda":
        raise ValueError(f"inv_chol: unsupported device {a.device}")
    fn = _kernel(a.dtype)
    Linv = torch.empty_like(a)
    L = torch.empty_like(a) if write_l else None
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = fn(a.data_ptr(), Linv.data_ptr(),
                 L.data_ptr() if write_l else None, B, S, stream)
    if err != 0:
        raise RuntimeError(f"inv_chol kernel launch failed: CUDA error {err}")
    kernel_counts.add("k1_launches")
    return (L, Linv) if write_l else Linv
