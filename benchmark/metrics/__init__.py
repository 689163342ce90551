"""Per-layer metrics: one reader a metric, ``<name>.py`` with ``read(trace)``
-> a number, or None where the trace holds nothing to read (the harness
then leaves the metric out). ``trace`` is ``core.Trace``."""
