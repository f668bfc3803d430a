"""The benchmark's reading of a ``torch.profiler`` trace of the card.

The per-kernel sums follow ``spamtree_tpu_torch/utils/profile_step.py`` at
commit 1ed94f536e0e (the device time of each CUDA event, summed by kernel
name; a replayed CUDA graph shows one device event per kernel node).  Busy
time is the union of the device events' intervals, so two streams'
overlapping work counts once; the idle gaps between them are named by the
innermost host operation that was running at the gap's middle.
"""

from __future__ import annotations

import time

import torch

# the hand-written kernels, by the name their launches carry
KERNELS = {"k1": "inv_chol_kernel", "k3": "thin_gibbs_",
           "k4": "thin_decision_kernel"}


def profiled(fn):
    """(fn's result, the profiler, wall seconds) of ``fn()`` run under
    ``torch.profiler`` with host and device activities, synchronised."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    return out, prof, wall


def _union(intervals):
    """Total length of the union of (start, end) intervals, and the gaps
    between the merged intervals as (start, end)."""
    total, gaps = 0.0, []
    cur_s = cur_e = None
    for s, e in sorted(intervals):
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s <= cur_e:
            cur_e = max(cur_e, e)
        else:
            total += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
    if cur_e is not None:
        total += cur_e - cur_s
    return total, gaps


def reduce(prof, wall_s: float, top: int = 10,
           after: str | None = None) -> dict:
    """What the benchmark reads from a trace: ``busy_s`` (seconds in which
    an operation ran on the device), ``window_s`` (the traced stretch's
    seconds), ``kernels`` [(name, device seconds, count)] by device time,
    ``kernel_s`` {k1, k3, k4: device seconds} of the hand-written kernels,
    and the ``breakdown`` of the result line: the ``top`` device operations
    by time and the ``top`` longest idle gaps, named by what the host was
    doing.  ``after`` (a host event's name, such as ``cudaGraphLaunch``):
    the stretch runs from its first occurrence after the last graph
    capture, so that the captures are left out, to the end of the last copy
    from the device into pinned host memory (the last chunk of kept draws),
    and ``launches`` counts its occurrences
    there; otherwise the stretch is the whole trace, ``wall_s`` long."""
    dev, host = [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == torch.autograd.DeviceType.CUDA:
            dev.append((tr.start, tr.end, e.name))
        elif tr.end > tr.start:
            host.append((tr.start, tr.end, e.name))
    marks = [h for h in host if h[2] == after] if after else []
    launches = None
    if marks:
        # from the first launch after the last capture (graphs of later
        # variants are captured at their first use) to the last copy of
        # kept draws to the host, which follows the last iteration's work:
        # the trailing drain on the host, with the device idle, is left out
        captures = [h[1] for h in host if "EndCapture" in h[2]
                    or "GraphInstantiate" in h[2]]
        t0 = min(h[0] for h in marks
                 if not captures or h[0] >= max(captures))
        dev = [d for d in dev if d[0] >= t0]
        # the chunks' copies into the drain's pinned buffers; the
        # pageable reads after the trailing drain (the adaptation's state)
        # and the accept reads are not the end
        copies = [d[1] for d in dev if "DtoH" in d[2] and "Pinned" in d[2]]
        end = max(copies) if copies else max(d[1] for d in dev)
        dev = [d for d in dev if d[0] <= end]
        window = (end - t0) / 1e6
        launches = sum(1 for h in marks if t0 <= h[0] <= end)
    else:
        window = wall_s
    by = {}
    for s, e, name in dev:
        tot, cnt = by.get(name, (0.0, 0))
        by[name] = (tot + (e - s) / 1e6, cnt + 1)
    rows = sorted(((k, v[0], v[1]) for k, v in by.items()),
                  key=lambda r: -r[1])
    busy_us, gaps = _union([(s, e) for s, e, _ in dev])
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = 0.5 * (s + e)
        inner = [h for h in host if h[0] <= mid <= h[1]]
        name = max(inner, key=lambda h: h[0])[2] if inner else "no host op"
        named.append([name, (e - s) / 1e6])
    return dict(
        busy_s=busy_us / 1e6, window_s=window, kernels=rows, launches=launches,
        kernel_s={k: sum(r[1] for r in rows if v in r[0])
                  for k, v in KERNELS.items()},
        breakdown=dict(device_ops=[[n, s] for n, s, _ in rows[:top]],
                       idle_gaps=named))
