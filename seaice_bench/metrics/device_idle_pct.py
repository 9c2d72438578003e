"""The share of the traced stretch in which no operation ran on the
device.  Layer: the device."""

from .. import devtrace

UNIT = "%"


def read(record):
    ops = record["device_ops"]
    wall = record["hi_us"] - record["lo_us"]
    if not ops or wall <= 0:
        return None
    return 100.0 * (1.0 - devtrace.intervals_union_us([(s, e) for _, s, e in ops]) / wall)
