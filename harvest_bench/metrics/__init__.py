"""One reader a per-layer metric, ``<metric name>.py``, found by name.

Each defines ``read(run)`` returning the metric's value, or None when the
run holds nothing to read (then the metric is left out of the line). A run
(``harvest_bench.run.Served``) holds the window's records (``window``), the
profiled stretch's readings (``trace``, None without ``--trace 1`` or
without a card), the allocator's peak over the window
(``peak_window_bytes``) and whether a card ran it (``cuda``)."""
