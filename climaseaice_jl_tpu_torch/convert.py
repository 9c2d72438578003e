"""State carried across: numpy arrays in, tensors out, and back.

``state_to_numpy`` reads any object with the :class:`SeaIceState`
attributes (this package's state, or the JAX package's, whose arrays
convert through ``numpy.asarray``) into a flat dict of numpy arrays:
one key per field, ``"time"`` and ``"iteration"`` for the clock, and
``"tracers/<name>"`` per extra tracer.  ``state_from_numpy`` builds this
package's state from such a dict on the model's grid.  There are no
weights: a model is rebuilt from its constructor arguments.

The side models carry theirs the same way: ``enthalpy_state_to_numpy``
gives ``H``, ``T``, ``phi``, ``kappa``, ``time`` and ``iteration`` of an
enthalpy column (or batch of columns), and ``coupled_state_to_numpy`` the
ice state under ``"ice/<key>"`` beside the ocean's fields (``T_ocean``,
``S_ocean``, ``prev_h``, ``Q_bottom`` and, over a dynamical ocean,
``u_ocean``, ``v_ocean``, ``eta``) and the clock.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .state import Clock, SeaIceState
from .enthalpy import EnthalpyState
from .coupled import IceOceanState

_FIELDS = tuple(f.name for f in dataclasses.fields(SeaIceState)
                if f.name not in ("tracers", "clock"))
_TRACER = "tracers/"
_ENTHALPY_FIELDS = tuple(f.name for f in dataclasses.fields(EnthalpyState) if f.name != "clock")
_OCEAN_FIELDS = tuple(f.name for f in dataclasses.fields(IceOceanState)
                      if f.name not in ("ice", "clock"))
_ICE = "ice/"


def _clock_to_numpy(clock, arrays):
    if clock is not None:
        arrays["time"] = _to_numpy(clock.time)
        arrays["iteration"] = _to_numpy(clock.iteration)
    return arrays


def _clock_from_numpy(arrays, dtype, device):
    return Clock(time=torch.full((), float(arrays.get("time", 0.0)), dtype=dtype, device=device),
                 iteration=torch.as_tensor(int(arrays.get("iteration", 0)),
                                           dtype=torch.int32, device=device))


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def state_to_numpy(state) -> dict[str, np.ndarray]:
    arrays = {name: _to_numpy(getattr(state, name)) for name in _FIELDS
              if getattr(state, name) is not None}
    for name, q in (state.tracers or {}).items():
        arrays[_TRACER + name] = _to_numpy(q)
    return _clock_to_numpy(state.clock, arrays)


def state_from_numpy(model, arrays: dict[str, np.ndarray]) -> SeaIceState:
    grid = model.grid
    unknown = set(arrays) - set(_FIELDS) - {"time", "iteration"} \
        - {k for k in arrays if k.startswith(_TRACER)}
    if unknown:
        raise ValueError(f"unknown state arrays {sorted(unknown)}")

    def field(name, q):
        q = np.asarray(q)
        if q.shape != grid.shape:
            raise ValueError(f"{name}: shape {q.shape}, grid fields are {grid.shape}")
        return torch.tensor(q, dtype=grid.dtype, device=grid.device)

    kw = {name: field(name, arrays[name]) for name in _FIELDS if name in arrays}
    kw["tracers"] = {k[len(_TRACER):]: field(k, q) for k, q in arrays.items()
                     if k.startswith(_TRACER)}
    kw["clock"] = _clock_from_numpy(arrays, grid.dtype, grid.device)
    return SeaIceState(**kw)


def enthalpy_state_to_numpy(state) -> dict[str, np.ndarray]:
    """An enthalpy state (this package's or the JAX package's) as a dict."""
    arrays = {name: _to_numpy(getattr(state, name)) for name in _ENTHALPY_FIELDS}
    return _clock_to_numpy(state.clock, arrays)


def enthalpy_state_from_numpy(model, arrays: dict[str, np.ndarray]) -> EnthalpyState:
    """This package's enthalpy state from such a dict, on the model's
    z-grid; a leading batch shape of columns is kept."""
    grid = model.grid
    unknown = set(arrays) - set(_ENTHALPY_FIELDS) - {"time", "iteration"}
    if unknown:
        raise ValueError(f"unknown state arrays {sorted(unknown)}")
    kw = {}
    for name in _ENTHALPY_FIELDS:
        q = np.asarray(arrays[name])
        if q.shape[-1:] != grid.shape:
            raise ValueError(f"{name}: shape {q.shape}, columns have {grid.shape[0]} cells")
        kw[name] = torch.tensor(q, dtype=grid.dtype, device=grid.device)
    return EnthalpyState(**kw, clock=_clock_from_numpy(arrays, grid.dtype, grid.device))


def coupled_state_to_numpy(cstate) -> dict[str, np.ndarray]:
    """An ice-ocean state (this package's or the JAX package's) as a dict:
    the ice's arrays under ``"ice/"``, the ocean's fields that are not
    None, the clock."""
    arrays = {_ICE + k: q for k, q in state_to_numpy(cstate.ice).items()}
    arrays.update({name: _to_numpy(getattr(cstate, name)) for name in _OCEAN_FIELDS
                   if getattr(cstate, name) is not None})
    return _clock_to_numpy(cstate.clock, arrays)


def coupled_state_from_numpy(iom, arrays: dict[str, np.ndarray]) -> IceOceanState:
    """This package's ice-ocean state from such a dict, on the ice model's
    grid; the ice state shares the coupled clock, as the step leaves it."""
    grid = iom.ice.grid
    unknown = (set(arrays) - set(_OCEAN_FIELDS) - {"time", "iteration"}
               - {k for k in arrays if k.startswith(_ICE)})
    if unknown:
        raise ValueError(f"unknown state arrays {sorted(unknown)}")
    ice = state_from_numpy(iom.ice, {k[len(_ICE):]: q for k, q in arrays.items()
                                     if k.startswith(_ICE)})
    kw = {}
    for name in _OCEAN_FIELDS:
        if name in arrays:
            q = np.asarray(arrays[name])
            if q.shape != grid.shape:
                raise ValueError(f"{name}: shape {q.shape}, grid fields are {grid.shape}")
            kw[name] = torch.tensor(q, dtype=grid.dtype, device=grid.device)
    clock = _clock_from_numpy(arrays, grid.dtype, grid.device)
    return IceOceanState(ice=ice.evolve(clock=clock), **kw, clock=clock)
