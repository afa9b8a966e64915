"""Percent of the traced window in which the device ran nothing."""

from perfbench.metrics._shared import idle_share as read  # noqa: F401
