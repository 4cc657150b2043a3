"""Start the ranks of a multi-device run: one process per rank, each with
one device and a ``torch.distributed`` process group.

No module of the JAX package is its counterpart (there one process drives
every device of the mesh).  :func:`spawn` starts the ranks with the
``spawn`` start method and a ``file://`` rendezvous in a temporary
directory (no TCP port to collide with another run's), builds the CUDA
kernels and the IO runtime in the calling process first (so that no two
ranks build at once), and returns each rank's result to the caller, in rank
order.  A rank that raises, or a run past its ``timeout``, kills every rank
and raises here: a deadlock fails, it never hangs.

:func:`run_jobs` is a rank entry of the package: it builds one-device
Simulations from a case's configuration and grid and drives the halo or the
all-gather step through a short script, returning what each step of the
script reports as numpy; the tests and ``chip_smoke.py`` use it.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import queue as queue_lib
import sys
import tempfile
import time as _time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from particlemethod_fsi_tpu_torch.parallel.comm import TRANSPORTS, Comm

# collective timeout where the caller gives no timeout of its own
DEFAULT_COLLECTIVE_SECONDS = 1800.0


def _rank_main(rank, world, init, transport, seconds, threads, fn, args,
               out):
    try:
        if threads:
            torch.set_num_threads(threads)
        if transport == "gloo":
            device = torch.device("cpu")
        else:
            device = torch.device("cuda", rank if transport == "nccl" else 0)
            torch.cuda.set_device(device)
        dist.init_process_group(
            "nccl" if transport == "nccl" else "gloo", init_method=init,
            world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=seconds))
        comm = Comm.from_process_group(device, transport)
        out.put((rank, True, fn(comm, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(fn, world: int, *args, transport: str,
          timeout: Optional[float] = 120.0,
          threads: Optional[int] = None) -> list:
    """Run ``fn(comm, *args)`` on ``world`` ranks and return their results
    (picklable; numpy arrays) in rank order.  ``fn`` is a module-level
    function (the child process imports it by name).  ``transport`` is one
    of :data:`comm.TRANSPORTS` and sets each rank's device: ``nccl`` gives
    rank ``r`` the card ``r``, ``gloo-host`` card 0 to every rank, ``gloo``
    the CPU; a CUDA transport without the cards raises.  ``timeout`` bounds
    the whole run and each collective (None: no bound on the run, 30
    minutes a collective); ``threads`` sets each rank's PyTorch CPU
    threads."""
    if transport not in TRANSPORTS:
        raise ValueError(f"transport {transport!r}: not one of {TRANSPORTS}")
    if transport != "gloo":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = world if transport == "nccl" else 1
        if cards < need:
            raise RuntimeError(f"transport {transport} for {world} ranks "
                               f"needs {need} CUDA devices, {cards} visible")
        from particlemethod_fsi_tpu_torch.io import native
        from particlemethod_fsi_tpu_torch.ops import cuda_loader

        cuda_loader.load()
        native.ensure_built()
    ctx = mp.get_context("spawn")
    seconds = timeout if timeout is not None else DEFAULT_COLLECTIVE_SECONDS
    deadline = None if timeout is None else _time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="fsi_ranks_") as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        out = ctx.Queue()
        procs = [ctx.Process(
            target=_rank_main, daemon=True,
            args=(r, world, init, transport, seconds, threads, fn, args,
                  out)) for r in range(world)]
        for p in procs:
            p.start()
        results = {}
        try:
            while len(results) < world:
                try:
                    rank, ok, payload = out.get(timeout=0.2)
                except queue_lib.Empty:
                    if deadline is not None and _time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world} ranks still running after {timeout} s")
                    dead = [r for r, p in enumerate(procs)
                            if r not in results and p.exitcode is not None]
                    if dead:
                        raise RuntimeError(
                            f"rank {dead[0]} exited with code "
                            f"{procs[dead[0]].exitcode} and no result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} of {world} failed:\n"
                                       f"{payload}")
                results[rank] = payload
            for p in procs:
                p.join(timeout=30)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    return [results[r] for r in range(world)]


# ---------------------------------------------------------------------------
# the package's scripted rank entry
# ---------------------------------------------------------------------------

def _halo_job(comm, sim, job):
    from particlemethod_fsi_tpu_torch import convert
    from particlemethod_fsi_tpu_torch.parallel import halo as ha

    hcfg = job.get("hcfg")
    if hcfg is not None:
        hcfg = ha.HaloConfig(*hcfg)
    runner = ha.make_halo_step(sim, comm, hcfg)
    if job.get("halo_state") is not None:
        state = convert.halo_state_from_numpy(
            job["halo_state"], comm.rank, comm.size, dtype=sim.dtype,
            device=sim.device)
    else:
        state = ha.partition_state(sim, comm, runner.hcfg,
                                   splits=job.get("splits"))
    out = [dict(op="setup", engine=runner.engine, hcfg=tuple(runner.hcfg))]
    for op, *arg in job["script"]:
        rec = dict(op=op)
        t0, c0 = comm.seconds, comm.calls
        w0 = _time.perf_counter()
        if op == "step":
            over = 0
            for _ in range(arg[0]):
                state, o = runner.step(state)
                over = max(over, o)
            rec.update(overflow=over)
        elif op == "run":
            state, over = runner.run_chunk(state, arg[0])
            rec.update(overflow=over, rebuilds=runner.last_chunk_rebuilds)
        elif op == "guarded":
            state, over, done, ok = runner.run_chunk_guarded(state, arg[0])
            rec.update(overflow=over, done=done, ok=ok)
        elif op == "regrow":
            grown, splits = ha.regrow_config(sim, comm, runner.hcfg, state)
            rows = ha.gathered_rows(comm, state)
            runner = ha.make_halo_step(sim, comm, grown)
            state = ha.partition_state(sim, comm, runner.hcfg,
                                       splits=splits, state=rows)
            rec.update(hcfg=tuple(runner.hcfg))
        elif op == "gather":
            rec.update(state=ha.gather_state(sim, comm, state),
                       s_pos=state.s_pos.cpu().numpy(),
                       splits=state.splits.cpu().numpy())
        else:
            raise ValueError(f"halo job: unknown op {op!r}")
        if sim.device.type == "cuda":
            torch.cuda.synchronize(sim.device)
        rec.update(seconds=_time.perf_counter() - w0,
                   comm_seconds=comm.seconds - t0, comm_calls=comm.calls - c0)
        out.append(rec)
    return out


def _allgather_job(comm, sim, job):
    from particlemethod_fsi_tpu_torch.parallel import sharding as sh
    from particlemethod_fsi_tpu_torch.state import to_numpy

    run_chunk = sh.make_sharded_runner(sim, comm)
    state = sh.shard_state(sim, comm, sim.state0)
    out = []
    for op, *arg in job["script"]:
        if op == "run":
            state = run_chunk(state, arg[0])
            out.append(dict(op=op))
        elif op == "gather":
            out.append(dict(op=op, state=to_numpy(
                sh.gather_state(comm, state), sim.n)))
        else:
            raise ValueError(f"all-gather job: unknown op {op!r}")
    return out


def run_jobs(comm: Comm, jobs: list) -> dict:
    """Rank entry: each job is a dict with ``mode`` (``"halo"`` or
    ``"allgather"``), ``cfg`` and ``grid`` (the case; a Simulation is built
    on this rank's device), ``script`` (a list of ``(op, *args)``) and, for
    the halo, optional ``hcfg`` (a tuple), ``splits`` or ``halo_state`` (a
    JAX partition as numpy, see :mod:`convert`).  Halo ops: ``("step",
    n)`` (``n`` fresh-frame steps), ``("run", n)``, ``("guarded", n)``,
    ``("regrow",)``, ``("gather",)``; all-gather ops: ``("run", n)``,
    ``("gather",)``.
    Returns ``{"jobs": [one list of records per job], "modules": [the
    top-level modules this rank imported]}``."""
    from particlemethod_fsi_tpu_torch.solver import Simulation

    results = []
    for job in jobs:
        sim = Simulation(job["cfg"], job["grid"], device=comm.device)
        run = _halo_job if job["mode"] == "halo" else _allgather_job
        results.append(run(comm, sim, job))
    return dict(jobs=results,
                modules=sorted({m.split(".")[0] for m in sys.modules}))

