"""The draws of ``spamtree_predict`` as replayed CUDA graphs.

Counterpart of the JAX package's compiled prediction chunk, a jitted
``lax.scan`` of ``predict_recompute`` over a chunk of kept draws
(``spamtree_tpu/api.py:904-910``): here one draw is captured in a CUDA
graph over static theta, w and z buffers and replayed for every later
draw.  The draws are made one at a time in draw order either way, so they
do not depend on the chunk, and a graphed run gives the eager loop's bits.
"""

from __future__ import annotations

import torch

from spamtree_tpu_torch.model import core, graph
from spamtree_tpu_torch.utils import trace


class DrawRunner:
    """``draw(theta, w, fill_z)``: the (m,) new rows ``new_pos`` of one
    prediction draw, ``core.predict_recompute(ms, theta, w, z)[new_pos]``,
    with z (n+1,) filled by ``fill_z(z)`` into the runner's buffer before
    the draw, outside any graph.  The result is the runner's buffer (graph
    memory once captured), which the next draw overwrites.

    ``graphs`` (default None: on for a CUDA model, off on the CPU): theta
    and w are copied into static buffers.  On a CUDA device the first draw
    runs eagerly on a side stream, then one draw is captured
    (``capture_s`` seconds, the span ``predict.capture``; its launches are
    not counted) and every later draw replays it (``replays`` counts
    them), adding to the kernels' counts (``ops.kernel_counts``) what the
    eager draw adds.  On the CPU, where there are no graphs, the same
    buffers go through plain calls.  Without graphs each draw is a plain
    call on the given tensors.  A capture that fails raises, naming the
    draw."""

    def __init__(self, ms: core.ModelStatic, n_theta: int, new_pos,
                 coords_cache=None, graphs=None):
        self.ms = ms
        self.cc = core.level_coords(ms) if coords_cache is None \
            else coords_cache
        self.graphs = ms.device.type == "cuda" if graphs is None \
            else bool(graphs)
        self.capture = self.graphs and ms.device.type == "cuda"
        kw = dict(dtype=ms.dtype, device=ms.device)
        self.new_pos = torch.as_tensor(new_pos, device=ms.device)
        self.z = torch.zeros(ms.n + 1, **kw)
        if self.graphs:
            self.theta = torch.zeros(n_theta, **kw)
            self.w = torch.zeros(ms.n + 1, **kw)
        self.graph = None
        self.capture_s = 0.0
        self.replays = 0

    def _draw(self, theta, w):
        return core.predict_recompute(self.ms, theta, w, self.z,
                                      self.cc)[self.new_pos]

    def draw(self, theta, w, fill_z):
        fill_z(self.z)
        if not self.graphs:
            return self._draw(theta, w)
        self.theta.copy_(theta)
        self.w.copy_(w)
        if self.graph is not None:
            self.graph.replay()
            self.replays += 1
            return self.graph.out
        if not self.capture:
            return self._draw(self.theta, self.w)
        return self._first_and_capture()

    def _first_and_capture(self):
        dev = self.ms.device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            out = self._draw(self.theta, self.w)
        torch.cuda.current_stream(dev).wait_stream(side)
        with trace.span("predict.capture") as sp:
            self.graph = graph.Graph("draw",
                                     lambda: self._draw(self.theta, self.w),
                                     torch.cuda.graph_pool_handle(), side,
                                     what="a prediction draw")
            torch.cuda.synchronize(dev)
        self.capture_s = sp.seconds
        return out

    def release(self):
        """Drop the graph and its memory."""
        self.graph = None
