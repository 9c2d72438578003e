"""The column's least time at the cell's shape (the layered snow-on-ice
column with its recorded fluxes, every stage) over the union device time of
kernel 2.11's launches, a step.  Layer: the column."""

from .. import devtrace

UNIT = "%"


def read(record):
    return devtrace.roofline_pct(record, "column")
