"""The program's layers in a traced stretch: which span enqueued each device
operation, and how long the host spent in each span.

The program marks its layers with spans (``climaseaice_jl_tpu_torch/
tracing.py``), host operations named ``seaice.*`` that nest as the calls
do.  A device operation is attributed through the host call that put it on
the stream (a kernel launch, an asynchronous copy or fill): on the
program's one stream the k-th such call, in the host's start order,
enqueued the k-th device operation in the device's start order.  The
profiler may miss the operations of the first few calls of its stretch
(on the H100 it has missed the first two copies of a stretch); those
calls are left out where the kinds of the calls (launch, copy, fill) then
match the kinds of the operations one for one.  Any other difference, or a
kind that does not match, refuses the pairing, and every reader returns
None rather than a wrong split.  Each paired operation goes to the
innermost span open when its call started.  (The device's and the host's
clocks drift apart by up to ~0.1 ms over a stretch, so an operation may
seem to start before its call: the order holds, the times do not say
more.)
"""

from __future__ import annotations

import re

from . import devtrace

PREFIX = "seaice."
# the runtime and driver calls that each put one device operation on the stream
ENQUEUE = re.compile(r"^cu(da)?(Launch(Cooperative)?Kernel|Memcpy|Memset)")
# the most calls at the start of a stretch whose operations may be missing
LOST_AT_START = 16


def _kind(name):
    """"copy", "fill" or "kernel", of a call or a device operation."""
    return "copy" if "Memcpy" in name else "fill" if "Memset" in name else "kernel"


def _spans(host_ops):
    """The program's spans, (name, start, end), by start (outer first)."""
    return sorted((op for op in host_ops if op[0].startswith(PREFIX)),
                  key=lambda op: (op[1], -op[2]))


def innermost(spans, times):
    """For each of the ascending ``times``, the name of the innermost of the
    nested ``spans`` open at it, or None."""
    out, stack, i = [], [], 0
    for t in times:
        while i < len(spans) and spans[i][1] <= t:
            while stack and stack[-1][2] < spans[i][1]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][2] < t:
            stack.pop()
        out.append(stack[-1][0] if stack else None)
    return out


def pair(record):
    """[(span name or None, device operation)] for every device operation,
    by the host call that enqueued it; None where there are no device
    operations or no spans, or the calls and operations do not pair."""
    device = sorted(record["device_ops"], key=lambda op: op[1])
    spans = _spans(record["host_ops"])
    calls = sorted((op for op in record["host_ops"] if ENQUEUE.match(op[0])),
                   key=lambda op: op[1])
    lost = len(calls) - len(device)
    if not device or not spans or not 0 <= lost <= LOST_AT_START:
        return None
    calls = calls[lost:]
    if any(_kind(c[0]) != _kind(d[0]) for c, d in zip(calls, device)):
        return None
    return list(zip(innermost(spans, [c[1] for c in calls]), device))


def device_ms(record, names):
    """The union of the device intervals of the operations whose innermost
    span is one of ``names``, in ms a step; None where :func:`pair` is."""
    pairs = pair(record)
    if pairs is None:
        return None
    mine = [(s, e) for span, (_, s, e) in pairs if span in names]
    return devtrace.intervals_union_us(mine) * 1e-3 / record["steps"]


def host_ms(record, names):
    """The host's time inside the spans named ``names``, summed, in ms a
    step; None where the record holds no such span."""
    mine = [e - s for name, s, e in record["host_ops"] if name in names]
    if not mine:
        return None
    return sum(mine) * 1e-3 / record["steps"]
