"""The comparison that decides a run's ``correct``.

The configuration's plain reference (``reference/<config>.py``) knows
nothing of the program: it makes its own initial state from the input
fields that the benchmark hands to both sides, and steps its own state.  It
follows the program one step from the program's own state: it takes the
program's state before the window's last step, runs one step of its own and
holds the program's state after that step to it.  What that skips is
checked by itself: the program's initial state against the reference's, the
program's clock against the steps driven, its halos against the images of its
interiors, and the final state for finite, physical values.

A reference may declare ``CLOCK_AND_NAMES = True``: its ``step`` then takes
the time of the program's clock before the step, ``time=`` (seasonal
forcing), and it cuts the program's fields itself, ``interior(q, halo,
name)``, and makes their halos from its cuts, ``halo_image(q, halo, name)``,
each by the field's name (a fold maps u, v and σ₁₂ to other indices than h,
and a y-face field's seam row is not in the interior).  A reference without
it is handed no time, and its fields are the interiors, their halos
periodic images.  A compared number's norm may name a region of the
reference's, ``q<p>@<region>``: the quantile is then taken over the live
points of ``region(<region>, name, shape, device)``.
"""

from __future__ import annotations

import math
import sys

import torch

TINY = 1e-30


def _named(ref):
    return getattr(ref, "CLOCK_AND_NAMES", False)


def _cut(ref, q, halo, name):
    if _named(ref):
        return ref.interior(q, halo, name)
    return q[halo:-halo, halo:-halo]


def _image(ref, q, halo, name):
    if _named(ref):
        return ref.halo_image(q, halo, name=name)
    return ref.halo_image(q, halo)


def interiors(state, names, halo, ref=None):
    """The interiors of the program's fields ``names`` (fresh copies), as
    ``ref`` cuts them."""
    return {n: _cut(ref, getattr(state, n), halo, n).detach().clone() for n in names}


def field_error(ref, got, norm="max", where=None):
    """The error of ``got`` against ``ref`` over the reference's size, in
    ``norm``: "max" (max |Δ| / max |ref|), "l2" (‖Δ‖₂ / ‖ref‖₂) or "q<p>",
    a share p of the live points (where either side is not 0; of those in
    the boolean mask ``where``, if given): the |Δ| that that share of them
    does not exceed (nearest rank), over max |ref|; 0 where the two are
    equal (NaN where both are NaN), infinite where only one is not finite."""
    r, g = ref.double(), got.double()
    same = (g == r) | (torch.isnan(g) & torch.isnan(r))
    d = torch.where(same, 0.0, g - r)
    if not bool(torch.isfinite(d).all()):
        return math.inf
    r = r.nan_to_num(nan=0.0, posinf=0.0, neginf=0.0)
    if norm.startswith("q"):
        live = (r != 0) | (g != 0)
        live = d.abs()[live if where is None else live & where]
        if not live.numel():
            return 0.0
        k = max(1, math.ceil(float(norm[1:]) * live.numel()))
        num, den = torch.kthvalue(live.cpu(), k).values, r.abs().max()
    elif norm == "max":
        num, den = d.abs().max(), r.abs().max()
    else:
        num, den = d.norm(), r.norm()
    return num.item() / max(den.item(), TINY) if num.item() else 0.0


def field_errors(ref, got, norm="max"):
    """``field_error`` of each of ``ref``'s fields."""
    return {n: field_error(r, got[n], norm) for n, r in ref.items()}


def named_error(ref, name, expected, got, norm):
    """``field_error`` of field ``name`` in ``norm``, a region's mask taken
    from the reference ``ref`` where the norm names one."""
    norm, _, region = norm.partition("@")
    where = ref.region(region, name, expected.shape, expected.device) if region else None
    return field_error(expected, got, norm, where)


def _bits_differ(a, b):
    return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())


def start_bits(ref, cfg, traffic, fields, state, halo):
    """Elements of the program's initial fields (halos included) whose bits
    differ from the reference's initial state, its halos the images."""
    initial = ref.initial(cfg, traffic, fields)
    return sum(_bits_differ(getattr(state, n), _image(ref, initial[n], halo, n))
               for n in ref.FIELDS)


def halo_bits(ref, state, halo):
    """Halo elements of the program's filled fields whose bits differ from
    the images of their interiors."""
    return sum(_bits_differ(getattr(state, n),
                            _image(ref, _cut(ref, getattr(state, n), halo, n), halo, n))
               for n in ref.FILLED)


def unphysical(state, names):
    """The count of non-finite values in the compared fields, and of points
    with h < 0 or ℵ outside [0, 1]; each kind that occurs is named on
    standard error."""
    kinds = {f"{n} not finite": int((~torch.isfinite(getattr(state, n))).sum()) for n in names}
    kinds.update({"h < 0": int((state.h < 0).sum()),
                  "a outside [0, 1]": int(((state.a < 0) | (state.a > 1)).sum())})
    for kind, n in kinds.items():
        if n:
            print(f"seaice_bench: {n} points with {kind}", file=sys.stderr)
    return sum(kinds.values())


def compared(ref, expected, got):
    """Each compared number of the reference: the largest error, in its
    norm, over its fields."""
    return {name: max(named_error(ref, f, expected[f], got[f], norm) for f in fields)
            for name, (fields, norm) in ref.COMPARED.items()}


def step(ref, cfg, traffic, start, dt, pre):
    """The reference's step from ``start`` (cuts of the program's state
    ``pre``), handed ``pre``'s clock where the reference takes one."""
    if _named(ref):
        return ref.step(cfg, traffic, start, dt, time=float(pre.clock.time))
    return ref.step(cfg, traffic, start, dt)


def judge(ref, cfg, traffic, limits, dt, fields, start_state, pre, post, counted, halo):
    """The numbers compared and their limits, and whether all hold.

    ``fields``: the input fields; ``start_state``: the program's initial
    state; ``pre``, ``post``: its states before and after the window's last
    step; ``counted``: the steps the harness drove.  A reference with
    ``CLOCK_AND_NAMES`` steps at the time of ``pre``'s clock.  Returns ``(correct, numbers)``,
    numbers mapping a short name to ``{"value", "limit"}``."""
    numbers = {"start_bits": start_bits(ref, cfg, traffic, fields, start_state, halo)}
    expected = step(ref, cfg, traffic, interiors(pre, ref.FIELDS, halo, ref), dt, pre)
    numbers.update(compared(ref, expected, interiors(post, ref.FIELDS, halo, ref)))
    del expected
    numbers.update(
        halo_bits=halo_bits(ref, post, halo),
        steps_lost=abs(counted - (int(post.clock.iteration) - int(start_state.clock.iteration))),
        unphysical=unphysical(post, ref.FIELDS))
    out = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    return all(v["value"] <= v["limit"] for v in out.values()), out
