"""How long a request waits for its micro-batch to start: the nearest
rank p95 of every ``queued_s`` (``submit`` to the ``query.batch`` span's
start, one a request) in the window, ms."""

import math

from perfbench.metrics._spans import roots


def read(ctx):
    batches = roots(ctx, "query.batch")
    if not batches:
        return None
    waits = sorted(q for r in batches for q in r.attrs.get("queued_s", ()))
    if not waits:
        return 0.0
    return 1e3 * waits[max(0, math.ceil(0.95 * len(waits)) - 1)]
