"""Device time a step of the operations the halo fills enqueued (the
``seaice.fill`` spans: the state's fill and the refill of the EVP
kernels' outputs).  Layer: the halo fills."""

from .. import spans

UNIT = "ms/step"


def read(record):
    return spans.device_ms(record, ("seaice.fill",))
