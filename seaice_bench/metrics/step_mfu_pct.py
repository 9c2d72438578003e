"""The whole step's least time (every piece of its work at the card's
float32 and memory peaks) over the median time a step of the untraced
window.  Layer: the whole step."""

import statistics

UNIT = "%"


def read(record):
    if not record["work_ms"] or not record["step_ms"]:
        return None
    return 100.0 * sum(record["work_ms"].values()) / statistics.median(record["step_ms"])
