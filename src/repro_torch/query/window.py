"""Adaptive micro-batch window — WHEN a pending serving batch executes.

A plain fixed window always waits ``window_s`` (or until
``max_batch`` ids piled up).  That is the right call only while waiting
keeps PAYING: the reason to hold a batch open is that concurrent
requests overlap (hub-heavy zipf traffic), so each arrival that shares
vertices with the pending set raises the dedup ratio and amortizes the
coalesced fetch further.  The moment arrivals stop overlapping, every
extra microsecond of window is pure latency with no fetch saved.

:class:`AdaptiveWindow` is that decision as an isolated, injectable-
clock state machine (so tests pin its transitions against synthetic
arrival schedules without threads): the engine reports each arrival,
and the window answers with a close reason the moment one fires —

* ``"full"``     — ``max_batch`` ids pending; executing now loses nothing;
* ``"plateau"``  — arrivals stopped overlapping the pending set: the
  MARGINAL overlap of each arrival (the fraction of its ids already
  pending or duplicated within it) stayed below ``min_overlap`` for
  ``patience`` consecutive arrivals.  The signal is deliberately
  per-arrival, not the delta of the cumulative dedup ratio — a
  cumulative ratio converges even while every arrival still
  half-duplicates the pending set (i.e. while waiting still saves half
  of each arrival's fetches);
* ``"timeout"``  — ``window_s`` elapsed (the engine's worker discovers
  this by waking from its timed wait; :meth:`timed_out` is the pure
  check).

Every executed batch records exactly one reason in
``QueryStats.close_reasons`` (sync calls record ``"direct"``, explicit
drains ``"flush"``), so ``sum(close_reasons.values()) == batches`` is an
engine invariant the differential suite asserts.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

#: every close reason the engine may record (the QueryStats invariant
#: check walks this list)
CLOSE_REASONS = ("full", "plateau", "timeout", "flush", "direct")


def close_reason_counts(close_reasons: dict) -> dict:
    """Normalize a ``QueryStats.close_reasons`` dict onto the full
    :data:`CLOSE_REASONS` axis (absent reasons become explicit zeros,
    unknown keys raise).  The observability layer uses this to compare
    stats counters against ``window_close`` span-event totals reason by
    reason — both sides on one fixed axis."""
    unknown = set(close_reasons) - set(CLOSE_REASONS)
    if unknown:
        raise ValueError(f"unknown close reasons {sorted(unknown)}; "
                         f"expected a subset of {CLOSE_REASONS}")
    return {r: int(close_reasons.get(r, 0)) for r in CLOSE_REASONS}


class AdaptiveWindow:
    """Pure micro-batch window state machine (no threads, no engine).

    Drive it with :meth:`arrival` per request and :meth:`timed_out` /
    :meth:`remaining` from the executor; :meth:`reset` when the pending
    batch is taken.  ``adaptive=False`` degrades to that fixed window
    (only ``"full"`` and ``"timeout"`` ever fire).
    """

    def __init__(self, *, window_s: float, max_batch: int,
                 adaptive: bool = True, patience: int = 2,
                 min_overlap: float = 0.05,
                 clock: Callable[[], float] = time.monotonic):
        if window_s < 0 or max_batch < 1:
            raise ValueError("window_s must be >= 0 and max_batch >= 1")
        if patience < 1:
            raise ValueError("patience must be >= 1")
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.adaptive = bool(adaptive)
        self.patience = int(patience)
        self.min_overlap = float(min_overlap)
        self._clock = clock
        self.reset()

    def reset(self) -> None:
        """Forget the pending batch (it was taken for execution)."""
        self._open = False
        self._t_open = 0.0
        self._total = 0
        self._unique = np.zeros(0, dtype=np.int64)  # sorted pending ids
        self._stale = 0
        self._arrivals = 0

    @property
    def is_open(self) -> bool:
        return self._open

    @property
    def pending_ids(self) -> int:
        return self._total

    @property
    def dedup_ratio(self) -> float:
        """Pending ids per unique pending id (>= 1 once non-empty)."""
        return self._total / self._unique.size if self._unique.size else 0.0

    def arrival(self, ids) -> Optional[str]:
        """Account one request's vertex ids; returns a close reason the
        moment this arrival makes waiting pointless, else None.

        All bookkeeping is vectorized, no per-id Python objects: the
        sorted pending-id array is probed with searchsorted
        (O(arrival * log pending)) and fresh ids are spliced in with one
        memmove (no re-sort) — the engine calls this under its pending
        lock on the serving hot path, so the worst per-arrival cost is
        one memcpy-rate pass over the pending set, never a sort of it.
        """
        ids = np.asarray(ids, dtype=np.int64).ravel()
        if not self._open:
            self._open = True
            self._t_open = self._clock()
        self._arrivals += 1
        self._total += ids.size
        overlap = None
        # unique-set bookkeeping exists only to feed the plateau signal;
        # a fixed (adaptive=False) window skips it entirely — submit's
        # hot path then pays nothing beyond the counters ("full" needs
        # only _total; dedup_ratio reads 0 in that mode)
        if self.adaptive and ids.size:
            uniq = np.unique(ids)
            if self._unique.size:
                known = np.isin(uniq, self._unique, assume_unique=True)
                fresh_ids = uniq[~known]
            else:
                fresh_ids = uniq
            if fresh_ids.size:
                self._unique = np.insert(
                    self._unique,
                    np.searchsorted(self._unique, fresh_ids), fresh_ids)
            # marginal overlap: the share of THIS arrival's ids the batch
            # already covers (cross-request + in-arrival duplicates)
            overlap = 1.0 - fresh_ids.size / ids.size
        if self._total >= self.max_batch:
            return "full"
        if overlap is None:   # fixed window, or an empty arrival
            return None
        # the first arrival has nothing to overlap with; judge from #2 on
        if self._arrivals >= 2:
            self._stale = 0 if overlap >= self.min_overlap \
                else self._stale + 1
            if self._stale >= self.patience:
                return "plateau"
        return None

    def timed_out(self) -> bool:
        """Pure timeout check on the WINDOW's clock.  Note the engine's
        executor times its real ``Event.wait`` with ``window_s`` in real
        seconds rather than calling this — the injectable clock may be
        virtual, and a thread wait must not take its timeout from it."""
        return self._open and self._clock() - self._t_open >= self.window_s

    def remaining(self) -> float:
        """Seconds of window left on the window's own clock."""
        if not self._open:
            return self.window_s
        return max(0.0, self.window_s - (self._clock() - self._t_open))
