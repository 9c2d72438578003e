"""Bit-exact checkpoint and restore of the model state.

Counterpart of `climaseaice_jl_tpu/io/checkpoint.py`.  A checkpoint is an
``.npz`` of every array of the state, keyed as the JAX package keys its
pytree paths (``h``, ``u``, ``tracers/<name>``, ``clock/time``,
``clock/iteration``; fields that are None are left out), so that a
checkpoint written by either package restores into the other.  Restore
takes the arrays verbatim: a run restored from a checkpoint continues bit
for bit as the run that wrote it.
"""

from __future__ import annotations

import dataclasses
import glob
import re

import numpy as np
import torch


def leaves(obj, prefix=""):
    """``(path, leaf)`` of every value that is neither None nor a container
    in the state ``obj`` (frozen dataclasses and dicts, in field order),
    with the JAX package's path names (`checkpoint.py:16-27`)."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            yield from leaves(getattr(obj, f.name), prefix + f.name + "/")
    elif isinstance(obj, dict):
        for k, v in obj.items():
            yield from leaves(v, prefix + str(k) + "/")
    elif obj is not None:
        yield prefix[:-1], obj


def to_numpy(leaf):
    """A leaf as a numpy array, its dtype kept."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def replace_leaves(obj, new, prefix=""):
    """``obj`` with each leaf whose path is a key of ``new`` replaced by
    that value."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        upd = {f.name: replace_leaves(getattr(obj, f.name), new, prefix + f.name + "/")
               for f in dataclasses.fields(obj)}
        return dataclasses.replace(obj, **upd)
    if isinstance(obj, dict):
        return {k: replace_leaves(v, new, prefix + str(k) + "/") for k, v in obj.items()}
    if obj is None:
        return None
    return new.get(prefix[:-1], obj)


def _device_of(state):
    for _, leaf in leaves(state):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return torch.device("cpu")


def save_checkpoint(path, state):
    """Write every array of ``state`` to ``path`` (.npz), keyed by its
    path."""
    np.savez(path, **{k: to_numpy(v) for k, v in leaves(state)})
    return path


def load_checkpoint(path):
    """A checkpoint as a ``{path: ndarray}`` dict."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


class Checkpointer:
    """Scheduled checkpoint writer and pickup source: writes
    ``<prefix>_iteration<N>.npz`` on schedule; :meth:`latest` gives the most
    recent file for ``Simulation.run(pickup=True)``."""

    def __init__(self, prefix, schedule):
        self.prefix = prefix
        self.schedule = schedule

    def maybe_write(self, sim):
        if self.schedule(sim):
            save_checkpoint(f"{self.prefix}_iteration{sim.iteration}.npz", sim.state)

    def latest(self):
        files = glob.glob(f"{self.prefix}_iteration*.npz")
        if not files:
            return None
        return max(files, key=lambda f: int(re.search(r"iteration(\d+)", f).group(1)))


def restore_state(template_state, checkpoint):
    """``template_state`` with every array the checkpoint (a path or a
    :func:`load_checkpoint` dict) holds for its paths taken verbatim, on
    the template's device; the rest kept."""
    if isinstance(checkpoint, str):
        checkpoint = load_checkpoint(checkpoint)
    device = _device_of(template_state)
    new = {k: torch.from_numpy(np.array(checkpoint[k])).to(device)
           for k, _ in leaves(template_state) if k in checkpoint}
    return replace_leaves(template_state, new)
