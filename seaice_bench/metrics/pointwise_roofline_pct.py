"""The pointwise work's least time at the cell's shape (the ice strength
and the two recorded winds, every stage) over the union device time of the
launches of kernels 2.8 and 2.10, a step.  Layer: the pointwise kernels."""

from .. import devtrace

UNIT = "%"


def read(record):
    return devtrace.roofline_pct(record, "pointwise")
