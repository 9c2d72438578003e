"""Device time a step of the operations the column enqueued (the
``seaice.column`` span).  Layer: the column."""

from .. import spans

UNIT = "ms/step"


def read(record):
    return spans.device_ms(record, ("seaice.column",))
