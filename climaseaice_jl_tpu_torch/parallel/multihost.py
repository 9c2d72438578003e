"""Joining a ``torch.distributed`` world, and moving states between their
global form and the ranks' shards.

Counterpart of `climaseaice_jl_tpu/parallel/multihost.py:43-111`: the JAX
package joins the multi-process runtime with ``jax.distributed`` and
places globally sharded arrays; here every rank is one process that holds
its own shard on its own device.

* :func:`initialize` joins the world (the ``mpiexec`` launch), with its
  address (``tcp://host:port``), size and rank given, as nothing on a
  single machine announces a cluster;
* :func:`shard_state` cuts a rank's shard from a global interior-only state;
* :func:`gather_state` reassembles the global interior-only state on every
  rank.

Per-rank snapshots and sharded checkpoints wait for the port's
``io/checkpoint.py`` (queue 6).
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist

from ..state import Clock


def initialize(init_method, world_size, rank, backend=None, timeout_s=None):
    """Join the world of ``world_size`` processes as ``rank``.

    ``backend`` defaults to NCCL where every rank of this host has a card
    of its own, else gloo (two ranks cannot share a card under NCCL; a
    host without a card runs its ranks on the CPU only where the caller
    asks for ``device="cpu"``).  Where the host has a card, the rank's
    device is :func:`default_device`; it becomes the current CUDA device,
    where the collectives of Python objects stage their bytes."""
    if backend is None:
        local = int(os.environ.get("LOCAL_WORLD_SIZE", world_size))
        backend = ("nccl" if torch.cuda.is_available() and torch.cuda.device_count() >= local
                   else "gloo")
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)
    if torch.cuda.is_available():
        torch.cuda.set_device(default_device())


def process_index():
    return dist.get_rank()


def process_count():
    return dist.get_world_size()


def default_device():
    """``cuda:{local rank mod cards}``: the ranks of a host share its cards
    round robin.  Raises where the host has no card, as
    :func:`..utils.resolve_device` does: a rank runs on the CPU only where
    its caller asks for ``"cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' to run the "
                           "ranks on the CPU")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def _map_fields(state, fn):
    """``state`` with ``fn`` applied to every 2-D field and tracer."""
    upd = {}
    for f in dataclasses.fields(state):
        q = getattr(state, f.name)
        if isinstance(q, torch.Tensor) and q.dim() == 2:
            upd[f.name] = fn(q)
    if state.tracers:
        upd["tracers"] = {k: fn(q) for k, q in state.tracers.items()}
    return state.evolve(**upd)


def shard_state(state_int, mesh):
    """This rank's shard of the global interior-only ``state_int`` (every
    rank holds the same one, typically built from the same initial
    condition), on the rank's device; the clock is replicated."""
    Px, Py = mesh.shape
    ix, iy = mesh.index

    def cut(q):
        nx, ny = q.shape[0] // Px, q.shape[1] // Py
        return q[ix * nx:(ix + 1) * nx, iy * ny:(iy + 1) * ny].to(mesh.device).contiguous()

    clock = state_int.clock
    return _map_fields(state_int, cut).evolve(clock=Clock(
        time=torch.as_tensor(clock.time, device=mesh.device),
        iteration=torch.as_tensor(clock.iteration, device=mesh.device)))


def gather_state(state_shard, mesh):
    """The global interior-only state on every rank (the
    ``reconstruct_global_field`` analog), on the rank's device."""
    Px, Py = mesh.shape

    def join(q):
        t = mesh.wire(q, copies=Px * Py - 1)
        parts = [torch.empty_like(t) for _ in range(Px * Py)]
        dist.all_gather(parts, t)
        cols = [torch.cat([parts[ix * Py + iy] for iy in range(Py)], 1) for ix in range(Px)]
        return torch.cat(cols, 0).to(q.device)

    return _map_fields(state_shard, join)
