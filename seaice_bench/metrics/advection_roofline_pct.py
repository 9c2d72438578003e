"""The tracer advection's least time at the cell's shape (WENO-7 on each
advected tracer, every stage) over the union device time of kernel 2.9's
launches, a step.  Layer: the tracers."""

from .. import devtrace

UNIT = "%"


def read(record):
    return devtrace.roofline_pct(record, "advection")
