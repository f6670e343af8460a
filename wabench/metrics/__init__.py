"""One reader a per-layer metric, found by the metric's name: each module
has ``read(record)``, which returns the metric's value from the window's
record (see ``harness.run_cell``), or None where it finds nothing to read.
"""
