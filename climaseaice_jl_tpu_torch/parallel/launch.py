"""Running the distributed step in local processes: the ``mpiexec`` of one
machine.

:func:`run_cases` spawns ``nprocs`` ranks joined over
``tcp://localhost:<free port>`` (gloo on the CPU, or where the ranks share
a card; NCCL where each has its own), each on one PyTorch thread, and runs
cases in them in turn: each case builds the same global model on every rank
(from a picklable ``(model, state)`` or a builder function importable by
the children), makes the distributed step on its mesh, steps the rank's
shard and gathers the interior-only result.  The kernels are built in the
parent first, so that the ranks do not race on the build directory.

:func:`probe_device_tensors` asks a two-rank gloo world whether its
send and receive take device tensors as they are.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import socket
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .. import _build
from .multihost import (initialize, default_device, shard_state, gather_state,
                        save_rank_snapshot, reassemble_rank_snapshots, save_sharded_checkpoint,
                        load_sharded_checkpoint)
from ..io.checkpoint import leaves
from ..dynamics.momentum import SplitExplicitSolver, loop_form
from .stepper import make_distributed_step, strip_halos
from ..dynamics import (fused_evp, fused_evp_tiled, fused_evp_padded, fused_evp_curvilinear,
                        fused_evp_tiled_padded, fused_evp_tiled_curvilinear, fixed_tile_advection,
                        fixed_tile_pointwise)
from ..thermodynamics import fixed_tile_thermo

FIELDS = ("u", "v", "h", "a", "hs", "sig11", "sig22", "sig12", "alpha")


def kernel_counters():
    """Every kernel wrapper's counter of this process, by kernel."""
    return {
        "2.1": fused_evp.evp_counter, "2.2": fused_evp_tiled.tiled_evp_counter,
        "2.3": fused_evp_padded.padded_evp_counter, "2.4": fused_evp_padded.evp_prep_counter,
        "2.5": fused_evp_tiled_padded.tiled_padded_evp_counter,
        "2.6": fused_evp_curvilinear.curvilinear_evp_counter,
        "2.7": fused_evp_tiled_curvilinear.tiled_curvilinear_evp_counter,
        "2.8": fused_evp_tiled_curvilinear.ice_strength_counter,
        "2.9": fixed_tile_advection.fixed_tile_advection_counter,
        "2.9 whole grid": fixed_tile_advection.whole_grid_advection_counter,
        "2.10": fixed_tile_pointwise.fixed_tile_pointwise_counter,
        "2.11": fixed_tile_thermo.fixed_tile_thermo_counter,
    }


def free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _run_case(case):
    """One case on this rank, inside its ``context``: ``(rank 0's result or
    None)``."""
    with case.get("context", contextlib.nullcontext)():
        return _run_case_steps(case)


def _run_case_steps(case):
    """The steps of one case.  The result holds the gathered interior-only
    fields as numpy arrays and every rank's record: its device, ms per step,
    kernel calls and launches in the steps, bytes sent and exchange rounds
    per step, and its split-explicit loop's form
    (:func:`..dynamics.momentum.loop_form`)."""
    device = default_device() if case.get("device") is None else torch.device(case["device"])
    if "build" in case:
        model, state = case["build"](**dict(case.get("kwargs", {}), device=device))
    else:
        model, state = case["model"], case["state"]
    dstep, mesh = make_distributed_step(model, case["mesh"], device=device)
    s = shard_state(strip_halos(model, state), mesh)
    counters = kernel_counters()
    for c in counters.values():
        c.reset()
    mesh.bytes_sent = mesh.rounds = 0
    step_ms = []
    for _ in range(case["steps"]):
        _sync(device)
        t0 = time.perf_counter()
        s = dstep(s, case["dt"])
        _sync(device)
        step_ms.append((time.perf_counter() - t0) * 1e3)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "CPU"
    solver = getattr(model.dynamics, "solver", None)
    loop = loop_form(dstep.local_model) if isinstance(solver, SplitExplicitSolver) else None
    record = dict(rank=dist.get_rank(), index=mesh.index, device=str(device), device_name=name,
                  loop=loop,
                  ms_per_step=step_ms, bytes_per_step=mesh.bytes_sent / case["steps"],
                  rounds_per_step=mesh.rounds / case["steps"],
                  stage=mesh.stage, calls={k: c.calls for k, c in counters.items()},
                  launches={k: c.launches for k, c in counters.items()})
    full = gather_state(s, mesh)
    names = [n for n in case.get("names", FIELDS) if getattr(full, n) is not None]
    snapshot = None
    if case.get("io") is not None:
        record["checkpoint_bitwise"], snapshot = _io_round_trip(s, full, mesh, names,
                                                                case["io"], case["steps"])
    records = [None] * dist.get_world_size()
    dist.all_gather_object(records, record)
    if dist.get_rank() != 0:
        return None
    out = dict(fields={n: getattr(full, n).cpu().numpy() for n in names}, records=records)
    if snapshot is not None:
        out["snapshot"] = snapshot
    return out


def _io_round_trip(s, full, mesh, names, directory, iteration):
    """Every rank writes its snapshot of the fields ``names``
    (``<directory>/snapshot_rank<P>_<iteration>.npz``) and its sharded
    checkpoint (``<directory>/checkpoint.rank<P>.npz``) of its shard ``s``,
    then restores the checkpoint onto its mesh against the gathered state
    ``full``.  Returns whether every array came back bit for bit, and on
    rank 0 the snapshot reassembled from all ranks' files."""
    prefix, ckpt = os.path.join(directory, "snapshot"), os.path.join(directory, "checkpoint")
    save_rank_snapshot(prefix, s, iteration, time=s.clock.time.cpu(), outputs=names, mesh=mesh)
    save_sharded_checkpoint(ckpt, s, mesh=mesh)
    dist.barrier()
    back, _ = load_sharded_checkpoint(ckpt, full, mesh)
    mine, theirs = dict(leaves(s)), dict(leaves(back))
    exact = mine.keys() == theirs.keys() and all(
        torch.equal(mine[k], theirs[k]) for k in mine)
    snapshot = None
    if dist.get_rank() == 0:
        snapshot = reassemble_rank_snapshots(prefix, iteration, tuple(full.h.shape))
    dist.barrier()
    return exact, snapshot


def _rank_main(rank, nprocs, port, backend, cases, queue):
    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(nprocs)
    torch.set_num_threads(1)
    initialize(f"tcp://localhost:{port}", nprocs, rank, backend=backend)
    try:
        results = [_run_case(case) for case in cases]
        if rank == 0:
            queue.put(results)
    finally:
        dist.destroy_process_group()


def _spawn(fn, nprocs, args, timeout):
    """Run ``fn(rank, *args, queue)`` in ``nprocs`` spawned processes and
    return what rank 0 put in the queue; raise if a rank fails or the
    deadline passes, and leave no process behind."""
    queue = mp.get_context("spawn").SimpleQueue()
    ctx = mp.start_processes(fn, args=tuple(args) + (queue,), nprocs=nprocs, join=False,
                             start_method="spawn")
    deadline = None if timeout is None else time.monotonic() + timeout
    result = None
    try:
        while True:
            if result is None and not queue.empty():
                result = queue.get()
            if ctx.join(timeout=0.2):
                break
            if deadline is not None and time.monotonic() > deadline:
                raise TimeoutError(f"ranks still running after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    if result is None and not queue.empty():
        result = queue.get()
    return result


def run_cases(cases, nprocs, backend=None, timeout=None):
    """Run ``cases`` in turn on ``nprocs`` spawned ranks; returns rank 0's
    result of each (see :func:`_run_case`).  A case is a dict: ``mesh``
    (Px, Py) with Px·Py = ``nprocs``, ``steps``, ``dt`` (as the serial step
    takes it), either ``model`` and ``state`` (picklable, on the CPU) or
    ``build`` (a module-level function returning ``(model, state)`` for a
    ``device`` keyword) with ``kwargs``; optionally ``names`` of the fields
    to return, ``device``, ``context``, a module-level function whose
    context manager the case runs in, and ``io``, a
    directory where every rank writes its snapshot and sharded checkpoint
    after the steps (:func:`_io_round_trip`; the result then holds the
    reassembled ``snapshot`` and each record ``checkpoint_bitwise``)."""
    if any(case.get("device", "cuda") != "cpu" for case in cases) and torch.cuda.is_available():
        _build.build()
    return _spawn(_rank_main, nprocs, (nprocs, free_port(), backend, list(cases)), timeout)


def _probe_main(rank, port, device, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank, timeout=datetime.timedelta(seconds=60))
    try:
        x = torch.full((4,), float(rank + 1), device=device)
        try:
            if rank == 0:
                dist.send(x, 1)
                outcome = "sent"
            else:
                dist.recv(x, 0)
                outcome = f"received {x.cpu().tolist()}"
        except Exception as err:          # the backend's refusal is the finding
            outcome = _last_line(err)
        print(f"gloo probe, rank {rank}: {outcome}", flush=True)
        answers = [None, None]
        dist.all_gather_object(answers, outcome)
        if rank == 0:
            queue.put(answers)
    finally:
        dist.destroy_process_group()


def _last_line(err):
    lines = [line for line in str(err).splitlines() if line.strip()]
    return f"{type(err).__name__}: {lines[-1][:200] if lines else ''}"


def probe_device_tensors(device="cuda", timeout=120):
    """What a two-rank gloo world does with send and receive of a tensor on
    ``device``: each rank's outcome (each rank also prints its own), or the
    failure of the run."""
    try:
        return _spawn(_probe_main, 2, (free_port(), str(device)), timeout)
    except Exception as err:
        return [_last_line(err)]
