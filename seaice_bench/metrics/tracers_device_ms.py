"""Device time a step of the operations the tracers enqueued (the
``seaice.tracers`` span: the WENO divergence and the tracer update).
Layer: the tracers."""

from .. import spans

UNIT = "ms/step"


def read(record):
    return spans.device_ms(record, ("seaice.tracers",))
