"""Spawn the ranks of one process group on this host and collect what each
returns.

``run_ranks(program, world, workdir, **inputs)`` starts ``world`` processes
(the ``spawn`` start method). Each selects ``device`` as its CUDA device
(when one is given), joins one process group on ``backend`` through a
``file://`` rendezvous in ``workdir`` (no TCP port, so runs side by side
never collide), runs ``program(rank, world, **inputs)``, leaves the group
and pickles the result into ``workdir``. The results come back in rank
order. ``program`` must be a module-level function and its inputs and
result picklable.

Every process is joined, or killed once ``timeout`` seconds have passed
since the start. With ``required`` (the default) a rank that raises, exits
nonzero or outlasts the timeout raises ``RuntimeError`` with the ranks'
tracebacks; without, that rank's result is None.
"""

from __future__ import annotations

import datetime
import multiprocessing
import pathlib
import pickle
import time
import traceback

import torch
import torch.distributed as dist


def _entry(program, rank, world, workdir, backend, device, pg_timeout_s, inputs):
    out = pathlib.Path(workdir)
    try:
        if device is not None:
            torch.cuda.set_device(device)
        kw = {} if pg_timeout_s is None else {"timeout": datetime.timedelta(seconds=pg_timeout_s)}
        dist.init_process_group(backend, init_method=f"file://{out / 'rendezvous'}",
                                rank=rank, world_size=world, **kw)
        try:
            result = program(rank, world, **inputs)
        finally:
            dist.destroy_process_group()
        (out / f"rank{rank}.pkl").write_bytes(pickle.dumps(result))
    except BaseException:
        (out / f"rank{rank}.error").write_text(traceback.format_exc())
        raise


def run_ranks(program, world, workdir, *, backend="gloo", device=None, timeout=120,
              pg_timeout_s=None, required=True, **inputs):
    """[result of rank 0, ..., result of rank world - 1] (see the module
    docstring); ``pg_timeout_s`` is the process group's own timeout."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry, args=(program, r, world, str(workdir), backend, device,
                                              pg_timeout_s, inputs), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(1.0, deadline - time.monotonic()))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(30)
    results = [workdir / f"rank{r}.pkl" for r in range(world)]
    if required and (any(p.exitcode for p in procs) or not all(r.exists() for r in results)):
        errors = "\n".join(e.read_text() for e in sorted(workdir.glob("rank*.error")))
        raise RuntimeError(f"ranks of {program.__name__} exited {[p.exitcode for p in procs]} "
                           f"(None: killed after {timeout} s)\n{errors}")
    return [pickle.loads(r.read_bytes()) if r.exists() else None for r in results]
