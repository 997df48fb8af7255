"""One reader per per-layer metric, ``<metric>.py``: ``LAYER``, ``UNIT``,
``SOURCE``, ``MOVES`` (the end-to-end metric it should move) and
``read(trace)``, which returns the value, or None where the traced run
holds nothing for it to read."""
