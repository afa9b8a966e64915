"""The traced window, read from ``torch.profiler``'s Chrome trace.

:func:`profile_window` runs a window under the profiler (host and
device activities) and returns a :class:`DeviceTrace`: every device
operation (kernels, copies, memsets) with its start, length and bytes,
and the host operations, so that readers can sum kernel time by name,
take transfer rates, split the window into busy and idle time (the
union of the device operations' intervals, as ``chip_smoke.py``'s idle
split reads ``key_averages``, but without counting overlaps twice) and
name what the host did while the device waited.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function")


@dataclass
class Op:
    name: str
    cat: str
    t0: float          # seconds, the trace's clock
    dur: float         # seconds
    nbytes: int = 0


@dataclass
class DeviceTrace:
    window_s: float
    device: list = field(default_factory=list)   # Op, by start
    host: list = field(default_factory=list)     # Op, by start

    def kernels(self, *needles: str) -> list:
        """Kernels whose name holds any of ``needles``."""
        return [o for o in self.device
                if o.cat == "kernel" and any(n in o.name for n in needles)]

    def seconds(self, ops) -> float:
        return sum(o.dur for o in ops)

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, merged."""
        out = []
        for o in sorted(self.device, key=lambda o: o.t0):
            a, z = o.t0, o.t0 + o.dur
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], z)
            else:
                out.append([a, z])
        return out

    def busy_s(self) -> float:
        return sum(z - a for a, z in self.busy_intervals())

    def top_device_ops(self, k: int = 10) -> list:
        """[name, seconds] of the ``k`` device operations that took the
        most time in all, summed by name."""
        by: dict = {}
        for o in self.device:
            by[o.name] = by.get(o.name, 0.0) + o.dur
        return [[n[:120], s] for n, s in
                sorted(by.items(), key=lambda kv: -kv[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """[what the host was doing, seconds]: the gaps between device
        operations, each named by the innermost host operation open at
        its middle, summed by that name, the ``k`` largest."""
        busy = self.busy_intervals()
        if not busy:
            return []
        t_lo = min(o.t0 for o in self.device + self.host)
        gaps = []
        prev = t_lo
        for a, z in busy:
            if a > prev:
                gaps.append((prev, a))
            prev = z
        hosts = sorted(self.host, key=lambda o: o.t0)
        starts = [o.t0 for o in hosts]
        by: dict = {}
        for a, z in gaps:
            mid = 0.5 * (a + z)
            name = "host work outside torch ops"
            # the latest-starting host op that still covers the middle
            hi = bisect.bisect_right(starts, mid)
            for i in range(hi - 1, max(-1, hi - 4097), -1):
                if hosts[i].t0 + hosts[i].dur >= mid:
                    name = hosts[i].name[:120]
                    break
            by[name] = by.get(name, 0.0) + (z - a)
        return [[n, s] for n, s in sorted(by.items(),
                                          key=lambda kv: -kv[1])[:k]]


def read_chrome_trace(path: str, window_s: float) -> DeviceTrace:
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    tr = DeviceTrace(window_s=window_s)
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") != "X" or "dur" not in ev:
            continue
        op = Op(ev.get("name", ""), cat, float(ev["ts"]) * 1e-6,
                float(ev["dur"]) * 1e-6,
                int((ev.get("args") or {}).get("bytes", 0) or 0))
        if cat in DEVICE_CATS:
            tr.device.append(op)
        elif cat in HOST_CATS:
            tr.host.append(op)
    tr.device.sort(key=lambda o: o.t0)
    return tr


def profile_window(work, scratch_dir: str | None = None):
    """``work()`` under ``torch.profiler`` (host and CUDA activities):
    returns ``(work's result, DeviceTrace)``.  The window's length is
    the host clock around ``work``; the Chrome trace goes to a temporary
    file in ``scratch_dir`` (``TMPDIR`` by default) and is removed once
    read."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = work()
        window = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json", dir=scratch_dir)
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        return out, read_chrome_trace(path, window)
    finally:
        os.unlink(path)
