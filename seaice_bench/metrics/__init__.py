"""Per-layer metric readers, one module a metric, named as the metric.

Each has ``UNIT`` and ``read(record)``, which returns the metric's value
from a traced stretch's record, or None where the record holds nothing to
read.  The record (:func:`seaice_bench.harness.traced_record`) holds
``steps``, ``device_ops`` and ``host_ops`` as (name, start µs, end µs),
``host_waits``, ``lo_us`` and ``hi_us`` (the stretch), ``step_ms`` (every
step's time in the untraced window just before, by CUDA events),
``work_ms`` (the least time of each piece of a step's work, ``"evp"`` the
EVP loop) and ``evp_kernels`` (the pattern of the EVP kernels' names), and
``kernels`` (the configuration's ``KERNELS``: a piece of ``work_ms`` → the
pattern of its kernels' names; empty where the configuration names none)."""
