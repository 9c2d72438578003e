"""Device operations (kernels, copies, fills) a step in the trace.  Layer:
the step's Python code and the kernel launchers."""

UNIT = "ops/step"


def read(record):
    return len(record["device_ops"]) / record["steps"]
