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
  rank;
* :func:`save_rank_snapshot` and :func:`reassemble_rank_snapshots` write
  each rank's shard of some fields and merge the files into global fields
  (`multihost.py:130-179`);
* :func:`save_sharded_checkpoint` and :func:`load_sharded_checkpoint` write
  each rank's shard of the whole state and restore it, bit for bit, on any
  mesh (`multihost.py:182-231`).

The files, their names and their keys (``<field>@<i0>_<j0>``: the shard's
offset in the global interior) are the JAX package's.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import os
import re

import numpy as np
import torch
import torch.distributed as dist

from ..io.checkpoint import leaves, replace_leaves, to_numpy
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


# --- per-rank output ---------------------------------------------------------------------

def _offset(q, mesh):
    """The global interior offset of this rank's shard ``q``."""
    return mesh.index[0] * q.shape[0], mesh.index[1] * q.shape[1]


def _shard_entries(leaf, mesh):
    """``[(key suffix, array)]`` of this rank's shard of ``leaf``: a 2-D
    field keyed by its offset, anything else as it is."""
    if isinstance(leaf, torch.Tensor) and leaf.dim() == 2:
        i0, j0 = _offset(leaf, mesh)
        return [(f"@{i0}_{j0}", to_numpy(leaf))]
    return [("", to_numpy(leaf))]


def save_rank_snapshot(prefix, state_shard, iteration, time=None, outputs=None, *, mesh):
    """Write this rank's shards of the fields ``outputs`` (default u, v, h,
    ℵ, hs) of ``state_shard`` to ``<prefix>_rank<P>_<iteration>.npz``, keyed
    ``<field>@<i0>_<j0>``; returns the path."""
    data = {}
    for name in (outputs or ("u", "v", "h", "a", "hs")):
        leaf = getattr(state_shard, name, None)
        if leaf is None and getattr(state_shard, "tracers", None):
            leaf = state_shard.tracers.get(name)
        if leaf is None:
            continue
        for suffix, arr in _shard_entries(leaf, mesh):
            data[name + suffix] = arr
    if time is not None:
        data["time"] = np.asarray(time)
    path = f"{prefix}_rank{process_index():03d}_{iteration:08d}.npz"
    np.savez(path, **data)
    return path


def reassemble_rank_snapshots(prefix, iteration, global_shape):
    """``{field: global ndarray}`` from every rank's
    :func:`save_rank_snapshot` file of ``iteration`` (and ``time``)."""
    fields = {}
    files = sorted(glob.glob(f"{prefix}_rank*_{iteration:08d}.npz"))
    if not files:
        raise FileNotFoundError(f"no rank files for {prefix} @ {iteration}")
    for f in files:
        with np.load(f) as d:
            for key in d.files:
                m = re.match(r"(.+)@(\d+)_(\d+)$", key)
                if not m:
                    fields.setdefault(key, d[key])
                    continue
                name, i0, j0 = m.group(1), int(m.group(2)), int(m.group(3))
                tgt = fields.setdefault(name, np.full(global_shape, np.nan, d[key].dtype))
                blk = d[key]
                tgt[i0:i0 + blk.shape[0], j0:j0 + blk.shape[1]] = blk
    return fields


# --- sharded checkpoints -------------------------------------------------------------------

def save_sharded_checkpoint(prefix, state_shard, clock=None, *, mesh):
    """Write this rank's shard of every array of ``state_shard`` (keys: the
    checkpoint's paths, with ``@<i0>_<j0>`` for the 2-D fields) to
    ``<prefix>.rank<P>.npz``, and ``clock`` as ``__clock__`` where given.
    Bit-exact."""
    data = {}
    for path, leaf in leaves(state_shard):
        for suffix, arr in _shard_entries(leaf, mesh):
            data[path + suffix] = arr
    if clock is not None:
        data["__clock__"] = np.asarray(clock)
    path = f"{prefix}.rank{process_index():03d}.npz"
    np.savez(path, **data)
    return path


def load_sharded_checkpoint(prefix, template_state, mesh):
    """``(this rank's shard, clock)`` of a sharded checkpoint on ``mesh``.
    Every rank reads every rank's file, rebuilds each field of the global
    interior-only ``template_state`` (whose other leaves stay where the
    files hold none) and cuts its shard (:func:`shard_state`), so a
    checkpoint restores onto any mesh, bit for bit."""
    merged, clock = {}, None
    for f in sorted(glob.glob(f"{prefix}.rank*.npz")):
        with np.load(f) as d:
            for key in d.files:
                if key == "__clock__":
                    clock = d[key]
                    continue
                m = re.match(r"(.+)@(\d+)_(\d+)$", key)
                if m:
                    merged.setdefault(m.group(1), []).append(
                        (int(m.group(2)), int(m.group(3)), d[key]))
                else:
                    merged.setdefault(key, d[key])
    new = {}
    for path, old in leaves(template_state):
        got = merged.get(path)
        if got is None:
            continue
        if isinstance(got, list):
            full = np.zeros(tuple(old.shape), got[0][2].dtype)
            for i0, j0, blk in got:
                full[i0:i0 + blk.shape[0], j0:j0 + blk.shape[1]] = blk
            got = full
        new[path] = torch.from_numpy(np.array(got))
    return shard_state(replace_leaves(template_state, new), mesh), clock
