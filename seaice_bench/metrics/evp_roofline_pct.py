"""The EVP loop's least time at the cell's shape over the union device time
of its kernels' launches, a step.  Layer: the EVP kernels."""

from .. import devtrace

UNIT = "%"


def read(record):
    evp = devtrace.matching(record["device_ops"], record["evp_kernels"])
    if not evp or "evp" not in record["work_ms"]:
        return None
    busy_ms = devtrace.intervals_union_us([(s, e) for _, s, e in evp]) * 1e-3
    return 100.0 * record["work_ms"]["evp"] / (busy_ms / record["steps"])
