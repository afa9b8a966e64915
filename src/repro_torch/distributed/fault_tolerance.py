"""Fault tolerance + straggler mitigation for long-running jobs.

* :class:`ResilientTrainer` — wraps the train loop: periodic (async)
  checkpoints, automatic restore-from-latest on step failure (a preempted
  or crashed host surfaces as an exception on relaunch), bounded retries.
  The step is an eager ``step_fn(state, batch) -> (state, metrics)``
  over dicts of tensors (the JAX package's is a pure jitted function).
* :class:`StragglerMonitor` — per-host step-time tracking with a robust
  (median * k) threshold, mirroring production heartbeat monitors.  The
  detection logic is host-count agnostic and unit-tested with synthetic
  fleets.
"""

from __future__ import annotations

import collections
import logging
import time
from typing import Any, Callable, Optional

import numpy as np

from repro_torch import checkpoint as ckpt

log = logging.getLogger(__name__)


class StragglerMonitor:
    """Flags hosts whose recent step times exceed ``k x`` the fleet median."""

    def __init__(self, n_hosts: int, *, window: int = 20, k: float = 2.0,
                 min_samples: int = 5):
        self.n_hosts = n_hosts
        self.k = k
        self.min_samples = min_samples
        self._times = [collections.deque(maxlen=window) for _ in range(n_hosts)]

    def record(self, host: int, step_time: float) -> None:
        self._times[host].append(step_time)

    def record_step(self, times: "np.ndarray | list[float]") -> None:
        for h, t in enumerate(times):
            self.record(h, float(t))

    def stragglers(self) -> list[int]:
        medians = []
        for dq in self._times:
            if len(dq) < self.min_samples:
                return []  # not enough evidence fleet-wide yet
            medians.append(float(np.median(dq)))
        fleet = float(np.median(medians))
        return [h for h, m in enumerate(medians) if m > self.k * fleet]

    def should_evict(self, host: int, *, patience: int = 3) -> bool:
        """Sustained straggler: the last ``patience`` samples all exceed."""
        dq = self._times[host]
        if len(dq) < max(patience, self.min_samples):
            return False
        fleet = float(np.median([np.median(d) for d in self._times if len(d)]))
        recent = list(dq)[-patience:]
        return all(t > self.k * fleet for t in recent)


class ResilientTrainer:
    """Checkpointed, restart-safe training loop.

    ``step_fn(state, batch) -> (state, metrics)`` returns a new state and
    leaves the one it was given as it was (the checkpoint writer may
    still be copying it); ``state`` is a nested dict of tensors (params +
    optimizer state + step).  Restored leaves go where the matching leaf
    of the running state lives.
    """

    def __init__(self, step_fn: Callable, state: Any, *, ckpt_dir: str,
                 ckpt_every: int = 50, keep_last: int = 3,
                 max_retries: int = 3):
        self.step_fn = step_fn
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every
        self.max_retries = max_retries
        self._checkpointer = ckpt.AsyncCheckpointer(ckpt_dir,
                                                    keep_last=keep_last)
        # restart-from-latest on construction (relaunch after a crash)
        step, state = ckpt.restore_latest(ckpt_dir, state)
        self.state = state
        self.start_step = step or 0
        if step is not None:
            log.info("restored checkpoint at step %d", step)

    def run(self, batches, *, n_steps: int,
            on_metrics: Optional[Callable[[int, Any], None]] = None,
            inject_failure_at: Optional[int] = None) -> Any:
        """Run ``n_steps`` training steps; retries a failing step from the
        last checkpoint.  ``inject_failure_at`` raises once at that step
        (used by the integration tests to prove the recovery path)."""
        it = iter(batches)
        step = self.start_step
        retries = 0
        injected = False
        while step < n_steps:
            batch = next(it)
            try:
                if inject_failure_at == step and not injected:
                    injected = True
                    raise RuntimeError(f"injected host failure at step {step}")
                t0 = time.monotonic()
                self.state, metrics = self.step_fn(self.state, batch)
                dt = time.monotonic() - t0
                retries = 0
            except Exception as e:  # noqa: BLE001 — any step failure
                retries += 1
                if retries > self.max_retries:
                    raise
                log.warning("step %d failed (%s); restoring latest checkpoint "
                            "(retry %d/%d)", step, e, retries, self.max_retries)
                self._checkpointer.wait()
                restored, self.state = ckpt.restore_latest(self.ckpt_dir,
                                                           self.state)
                step = restored or 0
                continue
            step += 1
            if on_metrics is not None:
                on_metrics(step, {**metrics, "step_time_s": dt})
            if step % self.ckpt_every == 0 or step == n_steps:
                self._checkpointer.save(step, self.state)
        self._checkpointer.wait()
        return self.state
