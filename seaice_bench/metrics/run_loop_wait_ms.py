"""The host's time a step inside the run loop's stop test and NaN check
(``seaice.run.stop_test``, ``seaice.run.nan_check``), where it reads the
card's clock and waits for the card.  Layer: the run loop."""

from .. import spans

UNIT = "ms/step"


def read(record):
    return spans.host_ms(record, ("seaice.run.stop_test", "seaice.run.nan_check"))
