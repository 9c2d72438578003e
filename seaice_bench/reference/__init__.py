"""The plain references, one a configuration (``<config>.py``, found by the
configuration's name), and the comparison that decides a run's ``correct``
(:mod:`.compare`)."""
