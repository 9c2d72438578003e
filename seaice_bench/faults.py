"""Faults planted underneath the timed path, which a run's comparison has to
refuse: the CPU tests drive whole runs with them (``seaice_bench/tests``),
and the control reads them at a cell's own size (``control.py``).

Each fault is a function of ``patch(obj, name, value)`` (``setattr`` that is
undone afterwards, as pytest's ``monkeypatch.setattr``) that breaks the
program's step where the fault lies.  :func:`planted` plants one for the
length of a ``with`` block.  A reference names the faults its cell can have
in ``FAULTS``; one without them has :data:`DEFAULT`.
"""

from __future__ import annotations

import contextlib

import climaseaice_jl_tpu_torch.fields as program_fields
import climaseaice_jl_tpu_torch.simulation as program_simulation

DAY = 86400.0


def _tick(state, dt):
    c = state.clock
    return state.evolve(clock=type(c)(time=c.time + dt, iteration=c.iteration + 1))


def _broken_step(patch, wrap):
    patch(program_simulation, "_step", wrap(program_simulation._step))


def unchanged(patch):
    """A step that returns its state, the clock advanced."""
    _broken_step(patch, lambda step: lambda model, state, dt: _tick(state, dt))


def one_answer_altered(patch):
    """One thickness, in the middle of the grid, raised by 0.1 of the
    largest."""
    def wrap(step):
        def broken(model, state, dt):
            out = step(model, state, dt)
            h = out.h.clone()
            g = model.grid
            h[g.Hx + g.Nx // 2, g.Hy + g.Ny // 2] += 0.1 * h.abs().max()
            return out.evolve(h=h)
        return broken
    _broken_step(patch, wrap)


def thickness_altered(patch):
    """Every thickness the step produces 1 % off: the basin's altered answer,
    where one point lies below float32's own reach."""
    def wrap(step):
        def broken(model, state, dt):
            out = step(model, state, dt)
            return out.evolve(h=out.h * 1.01)
        return broken
    _broken_step(patch, wrap)


def half_left_out(patch):
    """The upper half of the rows of h, ℵ, u and v left as they were."""
    def wrap(step):
        def broken(model, state, dt):
            out = step(model, state, dt)
            upd = {}
            for name in ("h", "a", "u", "v"):
                q = getattr(out, name).clone()
                half = q.shape[1] // 2
                q[:, half:] = getattr(state, name)[:, half:]
                upd[name] = q
            return out.evolve(**upd)
        return broken
    _broken_step(patch, wrap)


def fold_sign_flipped(patch):
    """Every fill of u and v across the fold without its change of sign."""
    patch(program_fields, "_FOLD_SIGN", dict(program_fields._FOLD_SIGN, fc=1.0, cf=1.0))


def fold_sign_flipped_inside(patch):
    """Every fill of u and v across the fold inside the step without its
    change of sign, the step's u and v then filled anew as they should be: a
    fault confined to the cap that leaves the state's halos as they were."""
    def wrap(step):
        def broken(model, state, dt):
            with planted(fold_sign_flipped):
                out = step(model, state, dt)
            fill = program_fields.FILLERS
            return out.evolve(u=fill[("f", "c")](out.u, model.grid),
                              v=fill[("c", "f")](out.v, model.grid))
        return broken
    _broken_step(patch, wrap)


def forcing_a_month_late(patch):
    """The step's forcing read 30 days after the state's clock."""
    def wrap(step):
        def broken(model, state, dt):
            c = state.clock
            out = step(model, state.evolve(clock=type(c)(time=c.time + 30 * DAY,
                                                         iteration=c.iteration)), dt)
            oc = out.clock
            return out.evolve(clock=type(oc)(time=oc.time - 30 * DAY, iteration=oc.iteration))
        return broken
    _broken_step(patch, wrap)


DEFAULT = ("unchanged", "one_answer_altered", "half_left_out")


def of(ref):
    """The faults ``ref``'s cell can have, by name."""
    return {name: globals()[name] for name in getattr(ref, "FAULTS", DEFAULT)}


@contextlib.contextmanager
def planted(fault):
    """``fault`` planted for the block, undone after it."""
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)
    try:
        fault(patch)
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def step(model, state, dt):
    """The program's step as the run loop takes it, with whatever is planted."""
    return program_simulation._step(model, state, dt)
