"""Reading a ``torch.profiler`` trace: the device's intervals, their union,
the host's waits on the device and the breakdown of the traced stretch.

``intervals_union_us`` and ``host_waits`` are frozen copies of the
arithmetic of ``chip_smoke.py:835-857`` (``profile_device_ms``, commit
25f59c9): the device's busy time is the union of the kernels' and copies'
intervals, not their sum (launches made as programmatic dependents start
inside their predecessor), and a host wait is a device-to-host read of a
value, ``aten::_local_scalar_dense``."""

from __future__ import annotations

import re

HOST_WAIT = "aten::_local_scalar_dense"
# a kernel's name in the breakdown is cut to this many characters (the
# template arguments of PyTorch's elementwise kernels run to thousands)
NAME_CHARS = 160


def intervals_union_us(spans):
    """The length of the union of (start, end) intervals."""
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(end - max(start, reach), 0.0)
        reach = max(reach, end)
    return busy


def gaps(spans, lo, hi):
    """The idle (start, end) intervals of [lo, hi] outside the union of
    ``spans``."""
    out, reach = [], lo
    for start, end in sorted(spans):
        if start > reach:
            out.append((reach, min(start, hi)))
        reach = max(reach, end)
    if hi > reach:
        out.append((reach, hi))
    return [(a, b) for a, b in out if b > a]


def record_from_profile(prof):
    """The traced stretch as plain data: device operations as (name, start
    µs, end µs), host operations likewise, and the count of host waits."""
    from torch.autograd import DeviceType

    device, host, waits = [], [], 0
    for e in prof.events():
        if e.is_user_annotation:
            continue
        span = (e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            device.append(span)
        else:
            host.append(span)
            if e.name == HOST_WAIT:
                waits += 1
    return {"device_ops": device, "host_ops": host, "host_waits": waits}


def matching(ops, pattern):
    rx = re.compile(pattern)
    return [op for op in ops if rx.search(op[0])]


def breakdown(device_ops, host_ops, lo, hi, top=10):
    """The device operations that took most time (name, seconds, summed by
    name) and the longest idle gaps of the device in [lo, hi] (µs), each
    named by the innermost host operation running at its middle."""
    by_name = {}
    for name, start, end in device_ops:
        name = name[:NAME_CHARS]
        by_name[name] = by_name.get(name, 0.0) + (end - start) * 1e-6
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(gaps([(s, e) for _, s, e in device_ops], lo, hi), key=lambda g: g[0] - g[1])
    host = sorted(host_ops, key=lambda op: op[1])
    named = []
    for a, b in idle[:top]:
        mid = 0.5 * (a + b)
        inner = [op for op in host if op[1] <= mid <= op[2]]
        label = max(inner, key=lambda op: op[1])[0] if inner else "host outside any operation"
        named.append([label, (b - a) * 1e-6])
    return {"device_ops": [[n, s] for n, s in ops], "idle_gaps": named}


def roofline_pct(record, piece):
    """The least time of the step's piece of work ``piece`` over the union
    device time a step of the launches of its kernels (the record's
    ``kernels[piece]`` pattern), in %; None where the configuration names no
    kernel for it, or the trace holds none of its launches."""
    pattern = record.get("kernels", {}).get(piece)
    if pattern is None or piece not in record["work_ms"]:
        return None
    ops = matching(record["device_ops"], pattern)
    if not ops:
        return None
    busy_ms = intervals_union_us([(s, e) for _, s, e in ops]) * 1e-3
    return 100.0 * record["work_ms"][piece] / (busy_ms / record["steps"])
