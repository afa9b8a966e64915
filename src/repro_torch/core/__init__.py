"""Formats, PG-Fuse cached reads, the loader API and the placement policy
(numpy-only; the device enters at ``data/graph_stream.py`` and
``query/engine.py``)."""
