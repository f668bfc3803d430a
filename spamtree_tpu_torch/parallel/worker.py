"""One rank of a ``parallel.launch`` job:

    python -m spamtree_tpu_torch.parallel.worker JOB_FILE RANK

Joins the job's process group, builds its mesh, calls the job's target on
it and, on rank 0, writes the return value beside the job file.  Any
failure is written there too and ends the process at once with exit code
1 (no wait on a collective that the other ranks will never join).
"""

from __future__ import annotations

import datetime
import importlib
import os
import pickle
import sys
import time
import traceback


def _write(path: str, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "wb") as f:
        pickle.dump(obj, f)
    os.replace(tmp, path)


def main(job_path: str, rank: int) -> None:
    with open(job_path, "rb") as f:
        job = pickle.load(f)
    out = job["out"]
    try:
        import torch
        import torch.distributed as dist

        import spamtree_tpu_torch  # noqa: F401  (the f32 precision pins)
        from spamtree_tpu_torch.parallel.mesh import make_mesh

        world = len(job["devices"])
        device = torch.device(job["devices"][rank])
        if device.type == "cuda":
            torch.cuda.set_device(device)
        elif "OMP_NUM_THREADS" not in os.environ:
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
        timeout = datetime.timedelta(seconds=job["group_timeout"])
        dist.init_process_group(
            job["backend"], init_method=job["init_method"],
            world_size=world, rank=rank, timeout=timeout)
        n_chains = job["n_chains"]
        mesh = make_mesh(n_chains, world // n_chains, device=device,
                         timeout=timeout)
        mesh.barrier()
        ready_at = time.time()
        module, name = job["target"].split(":")
        value = getattr(importlib.import_module(module), name)(
            mesh=mesh, **job["kwargs"])
        if rank == 0:
            _write(os.path.join(out, "result.pkl"),
                   dict(value=value, ready_at=ready_at))
        mesh.barrier()
        dist.destroy_process_group()
    except BaseException as e:  # reported to the launcher, then exit
        failed_at = time.time()
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
            exc = e
        except Exception:  # an exception that does not pickle: its text
            exc = None
        _write(os.path.join(out, f"error_{rank}.pkl"),
               dict(exc=exc, repr=repr(e), traceback=tb, time=failed_at))
        sys.stderr.write(tb)
        sys.stderr.flush()
        os._exit(1)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]))
