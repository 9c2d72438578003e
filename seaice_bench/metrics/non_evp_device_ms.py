"""Device time a step outside the EVP kernels' launches: the union of all
device intervals less that of the EVP launches.  Layer: the tracers, the
column and the fills (and the launchers' eager operations)."""

from .. import devtrace

UNIT = "ms/step"


def read(record):
    ops = record["device_ops"]
    if not ops:
        return None
    evp = devtrace.matching(ops, record["evp_kernels"])
    every = devtrace.intervals_union_us([(s, e) for _, s, e in ops])
    only_evp = devtrace.intervals_union_us([(s, e) for _, s, e in evp])
    return (every - only_evp) * 1e-3 / record["steps"]
