"""One worker process per device, for ``spamtree(devices=...)``.

``launch`` starts ``python -m spamtree_tpu_torch.parallel.worker`` once per
device, with the job (the target function, its arguments and the mesh
geometry) in a pickle file in a fresh temporary directory, which also
holds the ``file://`` rendezvous of the process group.  Every worker joins
the group (NCCL for CUDA devices, gloo for CPU devices), builds the mesh
and calls ``target(mesh=mesh, **kwargs)``; rank 0 writes its return value
back.  Subprocesses, not ``multiprocessing``: a spawned child re-imports
the caller's ``__main__``, which would run a user's script without a main
guard again.

A failed worker is never waited for: the launcher polls every worker,
and the first one to exit with an error has the others killed and its
exception raised here, with the worker's traceback attached.  The process
group's own timeout bounds any collective the workers wait in.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import tempfile
import time

import torch

_PKG_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# seconds a collective may wait: a backstop only, since a failed worker has
# the others killed at once
GROUP_TIMEOUT_S = 1800.0


class WorkerError(RuntimeError):
    """A worker failed with an exception that could not be sent back."""


def resolve_devices(devices) -> list:
    """The device list of ``devices=``: "all"/"auto" are every CUDA device
    (CUDA must be present); a device that does not exist raises, so no
    worker lands anywhere but where it was asked to."""
    if devices in ("all", "auto"):
        if not torch.cuda.is_available():
            raise RuntimeError(f"devices={devices!r} needs CUDA devices; "
                               f"pass a list such as ['cpu'] * 4 for CPU "
                               f"ranks")
        return [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    if isinstance(devices, (str, torch.device)):
        devices = [devices]
    out = [torch.device(d) for d in devices]
    if not out:
        raise ValueError("devices= is empty")
    kinds = {d.type for d in out}
    if len(kinds) != 1 or kinds - {"cpu", "cuda"}:
        raise ValueError(f"devices= must be all CPU or all CUDA, got "
                         f"{[str(d) for d in out]}")
    if "cuda" in kinds:
        if not torch.cuda.is_available():
            raise RuntimeError(f"devices={[str(d) for d in out]} requested "
                               f"but CUDA is not available")
        n = torch.cuda.device_count()
        idx = [0 if d.index is None else d.index for d in out]
        if any(i >= n for i in idx):
            raise RuntimeError(f"devices={[str(d) for d in out]}: this host "
                               f"has {n} CUDA device(s)")
        out = [torch.device("cuda", i) for i in idx]
    return [str(d) for d in out]


def picklable(kwargs: dict) -> None:
    """Raise TypeError naming the first argument that cannot be sent to a
    worker process."""
    for k, v in kwargs.items():
        try:
            pickle.dumps(v)
        except Exception as e:  # any pickling failure names its argument
            raise TypeError(
                f"spamtree(devices=...) sends its arguments to worker "
                f"processes, and {k}={v!r} cannot be pickled ({e}); pass "
                f"mesh= from ranks you start yourself instead") from e


def launch(target: str, kwargs: dict, devices, n_chains: int = 1,
           backend: str | None = None, timeout: float | None = None,
           path=()):
    """Run ``target(mesh=mesh, **kwargs)`` (``target`` as "module:function")
    on one worker per device of ``devices`` (already resolved), on an
    (n_chains, len(devices) // n_chains) mesh.  Returns (rank 0's return
    value, info): info["start_s"] the seconds from the launch until every
    worker had joined the mesh.  ``backend`` defaults to NCCL for CUDA
    devices and gloo for CPU ones; NCCL takes one rank per card.  ``timeout`` bounds the whole run
    (None: no bound); ``path`` is put on the workers' import path before
    the package's root."""
    world = len(devices)
    cuda = torch.device(devices[0]).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl" and len(set(devices)) != world:
        raise ValueError(f"NCCL takes one rank per card, got {devices}")
    with tempfile.TemporaryDirectory(prefix="spamtree-mesh-") as tmp:
        job = dict(target=target, kwargs=kwargs, devices=list(devices),
                   n_chains=n_chains, backend=backend,
                   init_method=f"file://{os.path.join(tmp, 'rendezvous')}",
                   group_timeout=GROUP_TIMEOUT_S, out=tmp)
        job_path = os.path.join(tmp, "job.pkl")
        with open(job_path, "wb") as f:
            pickle.dump(job, f)
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [*map(str, path), _PKG_ROOT]
            + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        t0 = time.time()
        procs = [subprocess.Popen(
            [sys.executable, "-m", "spamtree_tpu_torch.parallel.worker",
             job_path, str(r)], env=env) for r in range(world)]
        try:
            _wait(procs, tmp, None if timeout is None else t0 + timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
        with open(os.path.join(tmp, "result.pkl"), "rb") as f:
            res = pickle.load(f)
        return res["value"], dict(start_s=res["ready_at"] - t0)


def _wait(procs, tmp: str, deadline) -> None:
    """Poll the workers until all exit 0; raise the first failure's error
    (the caller kills the rest) or TimeoutError past ``deadline``."""
    while True:
        codes = [p.poll() for p in procs]
        if any(c not in (None, 0) for c in codes):
            _raise_worker_error(tmp, codes)
        if all(c == 0 for c in codes):
            return
        if deadline is not None and time.time() > deadline:
            raise TimeoutError(f"mesh workers still running at the launch "
                               f"timeout (exit codes {codes})")
        time.sleep(0.05)


def _raise_worker_error(tmp: str, codes: list):
    """Raise the error of the worker that failed first: the others' are
    most often the broken connections its exit left them."""
    errs = []
    for r in range(len(codes)):
        try:
            with open(os.path.join(tmp, f"error_{r}.pkl"), "rb") as f:
                errs.append((pickle.load(f), r))
        except FileNotFoundError:
            continue
    if not errs:
        raise WorkerError(f"mesh workers exited with codes {codes} and no "
                          f"error report")
    err, rank = min(errs, key=lambda e: e[0]["time"])
    exc = err["exc"]
    if not isinstance(exc, BaseException):
        exc = WorkerError(f"mesh worker {rank} failed: {err['repr']}")
    exc.add_note(f"in mesh worker {rank}:\n{err['traceback']}")
    raise exc
