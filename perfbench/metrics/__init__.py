"""Per-layer metric readers, one file each, found by the metric's name.

Each ``<name>.py`` defines ``read(ctx) -> float | None``; ``ctx`` has
``trace`` (:class:`perfbench.gen.devtrace.DeviceTrace` of the traced
window) and ``counters`` (what the cell's driver counted).  A reader that
finds nothing to read returns None and the metric is left out.
"""
