"""CUDA-graph capture of the port's parts, and where graphs run.

``Graph`` captures one part: a part of the MCMC iteration
(``model.mcmc.StepRunner``) or a prediction draw
(``model.predict.DrawRunner``).  ``graphs_default`` says whether
``graphs=None`` runs graphs, and ``check_capturable`` refuses a mesh whose
collectives a capture cannot hold.
"""

from __future__ import annotations

import torch

from spamtree_tpu_torch.ops import kernel_counts


def graphs_default(device_type: str, backend: str | None) -> bool:
    """Whether ``graphs=None`` runs graphs for a model on ``device_type``
    on a mesh over ``backend`` (None: no mesh): on CUDA alone or on an
    NCCL mesh; eager on the CPU and on a gloo mesh."""
    return device_type == "cuda" and backend in (None, "nccl")


def check_capturable(device_type: str, backend: str | None) -> None:
    """Raise where a capture cannot hold a collective of the mesh: gloo
    stages CUDA tensors through host memory."""
    if device_type == "cuda" and backend == "gloo":
        raise ValueError("CUDA graphs do not run on a gloo mesh: gloo "
                         "stages CUDA tensors through host memory, which "
                         "a capture cannot hold (graphs=False, or an "
                         "NCCL mesh)")


class Graph:
    """One part of the iteration (or of a prediction draw, ``what``)
    captured in a CUDA graph on ``stream`` (memory from ``pool``): ``out``
    holds what the part returned, in the graph's own memory, which each
    replay overwrites.  A replay adds to the kernels' counts
    (``ops.kernel_counts``) what the capture's calls counted
    (``counted``), every name alike; the capture itself launches nothing
    and leaves them as they were.  The capture bars host syncs on its own thread only, so
    the keep loop's drain thread may wait on its copies meanwhile.  A
    capture that fails raises, naming the part: the error it wraps names
    the operation that broke it."""

    def __init__(self, name: str, fn, pool, stream,
                 what: str = "the MCMC iteration"):
        before = kernel_counts.snapshot()
        self.graph = torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                self.out = fn()
        except Exception as e:
            raise RuntimeError(
                f"capturing part {name} of {what} in a CUDA graph "
                f"failed: {type(e).__name__}: {e}") from e
        finally:
            self.counted = kernel_counts.diff(before)
            kernel_counts.restore(before)

    def replay(self):
        self.graph.replay()
        for name, n in self.counted.items():
            kernel_counts.add(name, n)
