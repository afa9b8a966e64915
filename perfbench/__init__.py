"""The benchmark of the PyTorch/CUDA port (``repro_torch``).

``run.py`` runs one cell of ``BENCHMARK.json`` once on the card; see
``PERF.md`` for the cells, the metrics and the limits.
"""
