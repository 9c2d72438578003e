"""Device time a step of the operations the momentum step enqueued itself,
outside its EVP kernels (``seaice.evp``) and its fills (``seaice.fill``):
the EVP launchers' eager set-up.  Layer: the EVP launchers' eager work."""

from .. import spans

UNIT = "ms/step"


def read(record):
    return spans.device_ms(record, ("seaice.momentum",))
