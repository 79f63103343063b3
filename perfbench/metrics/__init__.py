"""One reader per metric, ``perfbench/metrics/<name>.py``, found by the
metric's name in ``BENCHMARK.json``.  An end-to-end reader's ``read(run)``
takes the window's record; a per-layer reader's ``read(trace)`` takes the
digested device trace (``perfbench/trace.py``).  A reader that finds
nothing to read returns None, and the metric is left out."""
