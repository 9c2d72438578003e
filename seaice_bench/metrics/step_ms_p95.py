"""The 95th percentile of the times of every step of the run's untraced
window (CUDA events at the step boundaries): the stalls a long run meets.
Layer: the whole step."""

import numpy as np

UNIT = "ms"


def read(record):
    if len(record["step_ms"]) < 2:
        return None
    return float(np.percentile(np.asarray(record["step_ms"], dtype=np.float64), 95.0))
