"""Work counts of the fit: floating-point operations and bytes accessed.

The counterpart of the JAX package's ``mcmc._chunk_cost``, which reads
XLA's cost analysis of the compiled keep chunk.  Here a ``Counter`` (a
``TorchDispatchMode``) sees every aten op that runs while it is active and
adds, from shapes and dtypes alone (it reads no value, so it issues no
host sync):

- operations: the formulas of ``torch.utils.flop_counter`` for the matrix
  products (``mm``, ``bmm``, ``addmm``, ``baddbmm``), 2 m n for a
  matrix-vector product, n^3/3 per factor for a Cholesky and n^2 k per
  batch for a triangular solve; one per output element of an elementwise
  op and one per input element of a reduction; none for data movement
  (copies, gathers, concatenation);
- bytes: each tensor input's and output's bytes (an in-place op's tensor
  is read and written); views, allocations and metadata count nothing.
  A broadcast input counts the elements it holds, not those it spans.

The hand-written kernels count their own defined work, whatever runs them:
a wrapper decorated with ``counted(work)`` adds ``work(...)`` -- the
kernel's bytes and operations, one function beside each kernel in
``ops/`` -- and the ops dispatched inside it (the plain version on the
CPU, the output allocations on the card) count nothing, so both devices
count the same work.
"""

from __future__ import annotations

import functools
import inspect
from typing import NamedTuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
)
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

aten = torch.ops.aten

KINDS = ("matmul", "linalg", "elementwise", "reduction", "movement", "kernel")

# allocations and views that are not flagged as views: no bytes move
_FREE = {aten.empty, aten.empty_like, aten.empty_strided, aten.new_empty,
         aten._unsafe_view, aten.detach, aten.lift_fresh}
# copies, some of them tagged pointwise: bytes, no operations
_COPIES = {aten.clone, aten.copy_, aten._to_copy}
# reductions by name, for a torch whose ops carry no reduction tag
_REDUCTIONS = {aten.sum, aten.mean, aten.amax, aten.amin, aten.max, aten.min,
               aten.prod, aten.all, aten.any, aten.logsumexp,
               aten.linalg_vector_norm, aten.cumsum}
_TAGS: dict = {}  # op packet -> the tags of any of its overloads


def _tagged(func, tag) -> bool:
    """Whether ``func`` or another overload of its op carries ``tag`` (an
    ``out=`` overload often carries none)."""
    packet = func.overloadpacket
    if packet not in _TAGS:
        _TAGS[packet] = {t for o in packet.overloads()
                         for t in getattr(packet, o).tags}
    return tag in func.tags or tag in _TAGS[packet]


def _mv_flops(args, _out):
    m, n = args[0].shape
    return 2 * m * n


def _cholesky_flops(args, _out):
    a = args[0]
    n = a.shape[-1]
    return a.shape[:-2].numel() * n ** 3 / 3


def _solve_triangular_flops(args, _out):
    A, b = args[0], args[1]
    n = A.shape[-1]
    batch = torch.broadcast_shapes(A.shape[:-2], b.shape[:-2]).numel()
    return batch * n * n * b.shape[-1]


_LINALG = {aten.mv: _mv_flops, aten.linalg_cholesky_ex: _cholesky_flops,
           aten.linalg_solve_triangular: _solve_triangular_flops}


def _held_bytes(t: torch.Tensor) -> int:
    """The bytes a tensor holds: its elements, a broadcast (stride-0)
    dimension counted once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size() if t.numel() else 0


def _tensors(tree):
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


class Work(NamedTuple):
    flops: float
    bytes: float


class Counter(TorchDispatchMode):
    """Counts the work of the ops that run while it is active (``with
    Counter() as c: ...``): ``c.work`` is the total, ``c.by_kind`` the
    operations and bytes of each of ``KINDS``, where "matmul" holds what
    ``torch.utils.flop_counter`` counts and "kernel" the hand-written
    kernels' own work."""

    def __init__(self):
        super().__init__()
        self.by_kind = {k: [0.0, 0.0] for k in KINDS}
        self._inside = 0  # > 0 inside a counted kernel wrapper

    @property
    def work(self) -> Work:
        return Work(sum(v[0] for v in self.by_kind.values()),
                    sum(v[1] for v in self.by_kind.values()))

    def add(self, kind: str, flops: float, nbytes: float):
        self.by_kind[kind][0] += flops
        self.by_kind[kind][1] += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        packet = func.overloadpacket
        if self._inside or func.is_view or packet in _FREE:
            return out
        ins = _tensors((args, {k: v for k, v in kwargs.items()
                               if k != "out"}))
        outs = _tensors(out)
        nbytes = sum(map(_held_bytes, ins)) + sum(map(_held_bytes, outs))
        if packet in flop_registry:
            kind, flops = "matmul", flop_registry[packet](*args, **kwargs,
                                                          out_val=out)
        elif packet in _LINALG:
            kind, flops = "linalg", _LINALG[packet](args, out)
        elif packet in _COPIES:
            kind, flops = "movement", 0
        elif _tagged(func, torch.Tag.pointwise):
            kind, flops = "elementwise", sum(t.numel() for t in outs)
        elif packet in _REDUCTIONS or (hasattr(torch.Tag, "reduction") and
                                       _tagged(func, torch.Tag.reduction)):
            kind, flops = "reduction", ins[0].numel() if ins else 0
        else:
            kind, flops = "movement", 0
        self.add(kind, float(flops), float(nbytes))
        return out


def active() -> Counter | None:
    """The innermost active ``Counter``, or None."""
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, Counter):
            return mode
    return None


def counted(work):
    """Decorate a kernel wrapper: under an active ``Counter`` a call adds
    ``work(**arguments)`` = (flops, bytes) as "kernel" work, and the ops
    it dispatches -- nested counted wrappers included -- count nothing.
    Without a counter the call costs one stack lookup."""

    def deco(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            c = active()
            if c is None or c._inside:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            c.add("kernel", *map(float, work(**bound.arguments)))
            c._inside += 1
            try:
                return fn(*args, **kwargs)
            finally:
                c._inside -= 1

        return wrapper

    return deco
