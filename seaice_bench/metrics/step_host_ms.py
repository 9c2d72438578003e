"""The host's time a step inside the step (the ``seaice.step`` span): how
long the host takes to enqueue a step.  Layer: the step code and
launchers."""

from .. import spans

UNIT = "ms/step"


def read(record):
    return spans.host_ms(record, ("seaice.step",))
