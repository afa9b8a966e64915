"""The hot-set tier a micro-batch: self time of ``query.hotset.lookup``
(with each hit's device-to-host copy), ``query.hotset.observe`` and
``query.hotset.fill`` (with each placed run's host-to-device copy)
under ``query.batch``, ms."""

from perfbench.metrics._spans import self_ms_per_batch


def read(ctx):
    return self_ms_per_batch(ctx, ("query.hotset.lookup",
                                   "query.hotset.observe",
                                   "query.hotset.fill"))
