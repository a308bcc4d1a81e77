"""Per-layer metrics, one reader a file: ``<name>.py`` holds ``UNIT``,
``LAYER``, ``MOVES`` and ``read(run)``, which takes the metric from the
run's records (``harness.Run``: the window's counters, the traced steps,
the per-encoder timings) and returns a number, or None when it finds
nothing to read (the harness then leaves the metric out). Modules whose
name starts with ``_`` are the yardstick they share: the model's FLOPs,
the voxel kernels' bytes and the trace arithmetic.
"""
