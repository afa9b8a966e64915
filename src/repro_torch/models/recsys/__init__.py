"""Recommender models of the port: DIN (``din.py``)."""

from repro_torch.models.recsys import din  # noqa: F401
