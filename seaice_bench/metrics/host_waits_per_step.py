"""Device-to-host reads of a value a step (``aten::_local_scalar_dense``):
each makes the host wait for the device.  Layer: the run loop."""

UNIT = "waits/step"


def read(record):
    return record["host_waits"] / record["steps"]
